"""Audio IO: decode → float32 mono 16 kHz, resampling, speed perturbation.

The reference delegates decoding to librosa/soundfile/ffmpeg (reference:
shared/audio.py:8-18) and speed-perturbs with scipy.signal.resample_poly
(reference: experiments/c2c-direct-mixed-tta/run.py:60-71). Here decoding is
two-tier: a dependency-free RIFF/WAV parser (PCM 8/16/24/32-bit + IEEE
float) for wav, and a native C++ decoder (native/audiodec.cpp,
libavformat/libavcodec/libswresample via ctypes, built on demand) for
compressed formats (mp3/m4a/ogg/...). Without the native toolchain,
compressed formats raise UnsupportedAudioFormat so callers can apply the
runner's skip policy (reference: benchmark/runner.py:299-303 skips missing
audio rather than scoring it wrong).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from fractions import Fraction
from pathlib import Path

import numpy as np
from scipy.signal import resample_poly

TARGET_SR = 16000

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_DEC_SRC = _NATIVE_DIR / "audiodec.cpp"
_DEC_LIB_PATH = Path(__file__).resolve().parent.parent / "_build" / "_audiodec.so"
_dec_lib: ctypes.CDLL | bool | None = None
_dec_lock = threading.Lock()


def _load_native_decoder() -> ctypes.CDLL | None:
    """Build (if needed) + load the ffmpeg-backed decoder; None if unavailable."""
    global _dec_lib
    if _dec_lib is not None:
        return _dec_lib if _dec_lib is not False else None
    with _dec_lock:
        if _dec_lib is not None:
            return _dec_lib if _dec_lib is not False else None
        if not _DEC_LIB_PATH.exists() or (
            _DEC_SRC.exists()
            and _DEC_LIB_PATH.stat().st_mtime < _DEC_SRC.stat().st_mtime
        ):
            # build beside the target and rename (concurrent processes)
            tmp = _DEC_LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
            try:
                _DEC_LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run(
                    [
                        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        str(_DEC_SRC), "-o", str(tmp),
                        "-lavformat", "-lavcodec", "-lavutil", "-lswresample",
                    ],
                    check=True, capture_output=True, timeout=180,
                )
                os.replace(tmp, _DEC_LIB_PATH)
            except Exception:
                tmp.unlink(missing_ok=True)
                _dec_lib = False
                return None
        try:
            lib = ctypes.CDLL(str(_DEC_LIB_PATH))
        except OSError:
            _dec_lib = False
            return None
        lib.tilawa_decode_audio.restype = ctypes.c_longlong
        lib.tilawa_decode_audio.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.tilawa_free_samples.restype = None
        lib.tilawa_free_samples.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _dec_lib = lib
        return lib


def _decode_native(path: Path, sr: int) -> np.ndarray | None:
    """Decode any container/codec via the native decoder; None if unavailable."""
    lib = _load_native_decoder()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    err = ctypes.create_string_buffer(256)
    n = lib.tilawa_decode_audio(str(path).encode(), sr, ctypes.byref(out), err, 256)
    if n < 0:
        raise UnsupportedAudioFormat(
            f"native decode failed for {path.name}: {err.value.decode(errors='replace')}"
        )
    try:
        samples = np.ctypeslib.as_array(out, shape=(n,)).astype(np.float32, copy=True)
    finally:
        lib.tilawa_free_samples(out)
    return samples


class UnsupportedAudioFormat(RuntimeError):
    pass


def _parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE blob → (float32 samples [n, channels], sample_rate)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise UnsupportedAudioFormat("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise UnsupportedAudioFormat("missing fmt/data chunk")
    audio_format, channels, sample_rate, _byte_rate, _block_align, bits = fmt
    if audio_format == 0xFFFE and len(data) >= 24:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits in (8, 16, 24, 32) else 3

    if audio_format == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise UnsupportedAudioFormat(f"PCM bits={bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise UnsupportedAudioFormat(f"float bits={bits}")
    else:
        raise UnsupportedAudioFormat(f"wav format tag {audio_format}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    else:
        x = x.reshape(-1, 1)
    return x, sample_rate


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (rational ratio) to target_sr."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    out = resample_poly(audio.astype(np.float64), frac.numerator, frac.denominator)
    return out.astype(np.float32)


def load_audio(path: str | Path, sr: int = TARGET_SR) -> np.ndarray:
    """Decode an audio file → float32 mono at `sr` (default 16 kHz)."""
    path = Path(path)
    data = path.read_bytes()
    if data[:4] == b"RIFF":
        x, native_sr = _parse_wav(data)
    else:
        decoded = _decode_native(path, sr)
        if decoded is None:
            raise UnsupportedAudioFormat(
                f"{path.suffix or 'unknown'} decoding unavailable (native "
                "audiodec not built and file is not RIFF/WAV)"
            )
        return decoded
    mono = x.mean(axis=1) if x.shape[1] > 1 else x[:, 0]
    return resample(mono, native_sr, sr)


def save_wav(path: str | Path, audio: np.ndarray, sr: int = TARGET_SR) -> None:
    """Write float32 mono audio as 16-bit PCM WAV."""
    x = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, 1,
        sr, sr * 2, 2, 16, b"data", len(pcm),
    )
    Path(path).write_bytes(hdr + pcm)


def speed_perturb(audio_16k: np.ndarray, factor: float) -> np.ndarray:
    """Tempo+formant shift by `factor` via rational resampling
    (reference: c2c-direct-mixed-tta/run.py:60-71 — resample to
    16*factor kHz then treat as 16 kHz)."""
    if factor == 1.0:
        return audio_16k.astype(np.float32)
    frac = Fraction(factor).limit_denominator(100)
    out = resample_poly(
        audio_16k.astype(np.float64), frac.numerator, frac.denominator
    )
    return out.astype(np.float32)


def duration_seconds(audio: np.ndarray, sr: int = TARGET_SR) -> float:
    return float(len(audio)) / sr
