"""Batched, length-masked log-mel frontend.

Port of tilawa_tpu/ops/frontend.py. Spec: 16 kHz, 512-point FFT, 400
window / 160 hop (center=False), periodic Hann, pre-emphasis 0.97, 80 HTK
mel filters 0..8 kHz with Slaney normalization, power spectrum,
ln(mel + 1e-5), per-feature mean/std normalization over the valid frames.

`fused_log_mel` launches the hand-written CUDA kernel (csrc/log_mel.cu, a
shared-memory FFT per frame) for a CUDA tensor and uses `log_mel_plain`
(framing + Hann + rfft + power + mel + ln, all f32) for a CPU tensor; the
plain version is also what the kernel is held against on the card. The
tables (the window, the dense filterbank for the plain version, the FFT's
twiddles and the filterbank as bands of non-zero bins for the kernel) are
built here in numpy and live on the device as `MelTables`, which the model
owns as buffers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tilawa_tpu_torch.ops import kernels

SAMPLE_RATE = 16000
N_FFT = 512
WIN_LENGTH = 400
HOP_LENGTH = 160
N_MELS = 80
N_FREQS = N_FFT // 2 + 1
PREEMPH = 0.97
LOG_GUARD = 1e-5
F_MIN = 0.0
F_MAX = 8000.0


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def mel_filterbank(
    n_mels: int = N_MELS,
    n_fft: int = N_FFT,
    sample_rate: int = SAMPLE_RATE,
    f_min: float = F_MIN,
    f_max: float = F_MAX,
) -> np.ndarray:
    """[n_freqs, n_mels] HTK-scale triangular filters, Slaney-normalized."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)
    fb = np.zeros((n_freqs, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        # Slaney normalization: 2 / bandwidth
        fb[:, m] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=2)
def hann_window(win_length: int = WIN_LENGTH) -> np.ndarray:
    """Periodic Hann window."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def num_frames(n_samples: int) -> int:
    """Frame count for center=False framing."""
    return max(0, 1 + (n_samples - WIN_LENGTH) // HOP_LENGTH)


def frames_for_length(length: torch.Tensor) -> torch.Tensor:
    """num_frames for an int tensor of sample counts."""
    return torch.clamp(1 + (length - WIN_LENGTH) // HOP_LENGTH, min=0)


def twiddles() -> np.ndarray:
    """exp(-2πi m / 512) for m < 512 as [512, 2] f32 (cos, −sin), built in
    float64 and rounded once: the kernel's FFT stages and its split step
    take every twiddle from this table."""
    ang = 2.0 * np.pi * np.arange(N_FFT, dtype=np.float64) / N_FFT
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def mel_bands() -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as bands: ([80, 3] int32 of each mel's first bin, bin
    count and offset into the weights; the weights f32, mel by mel in bin
    order). A band runs from a mel's first to its last non-zero bin."""
    fb = mel_filterbank()
    bands = np.zeros((fb.shape[1], 3), np.int32)
    weights = []
    offset = 0
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        first, count = int(nz[0]), int(nz[-1] - nz[0]) + 1
        bands[m] = first, count, offset
        weights.append(fb[first:first + count, m])
        offset += count
    return bands, np.concatenate(weights).astype(np.float32)


class MelTables(NamedTuple):
    window: torch.Tensor        # [WIN] f32
    fb: torch.Tensor            # [257, 80] f32 (the plain version)
    twiddle: torch.Tensor       # [512, 2] f32
    bands: torch.Tensor         # [80, 3] int32: first bin, bin count, weight offset
    band_weights: torch.Tensor  # [non-zeros] f32


def mel_tables(device: str | torch.device = "cpu") -> MelTables:
    bands, weights = mel_bands()
    # torch.tensor copies: the window and filterbank arrays are lru-cached
    return MelTables(*(
        torch.tensor(a, device=device)
        for a in (hann_window(), mel_filterbank(), twiddles(), bands, weights)
    ))


def log_mel_plain(
    pre: torch.Tensor, tables: MelTables, eps: float = LOG_GUARD
) -> torch.Tensor:
    """Pre-emphasized waveform [B, N] f32 → log-mels [B, T, 80] f32:
    framing, Hann, rfft, power, mel, ln."""
    frames = pre.unfold(-1, WIN_LENGTH, HOP_LENGTH) * tables.window  # [B, T, WIN]
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2                          # [B, T, 257]
    return torch.log(torch.matmul(power, tables.fb) + eps)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def fused_log_mel(
    pre: torch.Tensor, tables: MelTables, eps: float = LOG_GUARD
) -> torch.Tensor:
    """Pre-emphasized waveform [B, N] → log-mels [B, T, 80] in one kernel on
    a CUDA tensor (the 257-bin power spectrum never leaves the chip);
    log_mel_plain on a CPU tensor. Normalization stays outside (it needs
    the true lengths)."""
    kernels.forward_only("fused_log_mel", pre)
    if pre.device.type == "cpu":
        return log_mel_plain(pre, tables, eps)
    if pre.device.type != "cuda":
        raise ValueError(f"fused_log_mel runs on cuda or cpu tensors, got {pre.device}")
    if pre.dim() != 2 or pre.dtype != torch.float32 or not pre.is_contiguous():
        raise ValueError("pre must be a contiguous float32 [B, N] tensor")
    layouts = {
        "window": ((WIN_LENGTH,), torch.float32), "twiddle": ((N_FFT, 2), torch.float32),
        "bands": ((N_MELS, 3), torch.int32),
        "band_weights": ((len(mel_bands()[1]),), torch.float32),
    }
    for name, (shape, dtype) in layouts.items():
        t = getattr(tables, name)
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != pre.device or not t.is_contiguous()):
            raise ValueError(f"table {name} must be contiguous {dtype} {shape} on {pre.device}")
    b, n = pre.shape
    t_frames = num_frames(n)
    out = torch.empty((b, t_frames, N_MELS), dtype=torch.float32, device=pre.device)
    if b and t_frames:
        fn = kernels.function("log_mel", "tilawa_log_mel", _ARGTYPES)
        err = fn(
            pre.data_ptr(), tables.window.data_ptr(), tables.twiddle.data_ptr(),
            tables.bands.data_ptr(), tables.band_weights.data_ptr(), out.data_ptr(),
            b, n, t_frames, tables.band_weights.shape[0], eps,
            torch.cuda.current_stream(pre.device).cuda_stream,
        )
        kernels.check(err, "fused_log_mel")
        kernels.LAUNCHES["log_mel"] += 1
    return out


def _time_sums(x: torch.Tensor) -> torch.Tensor:
    """[B, T, F] → [B, 1, F] sums over time, one batch row at a time: a
    reduction over the whole batch picks its launch shape, and with it the
    order of its f32 sums, from B, so a row's statistics (and every layer
    after them) would change with the rows batched beside it."""
    if x.shape[0] == 1:
        return x.sum(dim=1, keepdim=True)
    return torch.cat([row.sum(dim=1, keepdim=True) for row in x.split(1)])


def log_mel_spectrogram(
    audio: torch.Tensor,     # [B, N] float32
    lengths: torch.Tensor,   # [B] int — valid sample counts
    tables: MelTables,
    eps: float = LOG_GUARD,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched waveform → (normalized features [B, T, 80] f32, feat_lengths
    [B] int32). Frames beyond a sample's true length are zeroed;
    per-feature normalization statistics use only valid frames.
    use_kernel=False runs log_mel_plain on any device."""
    # Preemphasis: y[0] = x[0], y[t] = x[t] - c*x[t-1].
    pre = torch.cat([audio[:, :1], audio[:, 1:] - PREEMPH * audio[:, :-1]], dim=1)
    logmel = (fused_log_mel if use_kernel else log_mel_plain)(pre, tables, eps)
    return normalize_log_mel(logmel, lengths)


def normalize_log_mel(
    logmel: torch.Tensor,    # [B, T, 80] f32
    lengths: torch.Tensor,   # [B] int — valid sample counts
) -> tuple[torch.Tensor, torch.Tensor]:
    """log_mel_spectrogram's per-feature normalization over each sample's
    valid frames, padded frames zeroed; (features, feat_lengths)."""
    t_frames = logmel.shape[1]
    feat_lengths = frames_for_length(lengths).to(torch.int32)
    mask = (
        torch.arange(t_frames, device=logmel.device)[None, :] < feat_lengths[:, None]
    )[..., None]                                                    # [B, T, 1]

    cnt = torch.clamp(feat_lengths[:, None, None].to(logmel.dtype), min=1.0)
    masked = torch.where(mask, logmel, 0.0)
    mean = _time_sums(masked) / cnt
    var = _time_sums(torch.where(mask, logmel - mean, 0.0) ** 2) / cnt
    std = torch.sqrt(var)
    normed = torch.where(mask, (logmel - mean) / torch.clamp(std, min=1e-10), 0.0)
    return normed.to(torch.float32), feat_lengths
