"""SpecAugment: time/frequency masking on mel features.

Port of tilawa_tpu/ops/specaug.py. Same widths, starts and clipping to
each example's valid length: per example, `freq_masks` bands of width
floor(u·(freq_width+1)) starting at floor(u·max(F - width, 1)), and
`time_masks` stripes of width floor(u·(max(len·time_frac, 1) + 1))
starting at floor(u·max(len - width, 1)), never past the valid length; u
uniform in [0, 1) in f32, the arithmetic in f32 as in the JAX package. The
draws come from an explicit torch.Generator (no bitwise match with
jax.random is intended), all in one call per kind, so one generator state
gives one set of masks on any device of that generator.
"""

from __future__ import annotations

import torch


def _interval_mask(size: int, starts: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """[B, M] starts/widths → [B, size] bool, True where any [start,
    start+width) interval of the row covers."""
    iota = torch.arange(size, device=starts.device)[None, None, :]
    hit = (iota >= starts[..., None]) & (iota < (starts + widths)[..., None])
    return hit.any(dim=1)


def spec_augment(
    feats: torch.Tensor,         # [B, T, F]
    lengths: torch.Tensor,       # [B] valid frame counts
    generator: torch.Generator,
    freq_masks: int = 2,
    freq_width: int = 27,
    time_masks: int = 10,
    time_frac: float = 0.05,
    mask_value: float = 0.0,
    rows: slice | None = None,
) -> torch.Tensor:
    """Mask `freq_masks` random mel bands and `time_masks` random time
    stripes (each up to `time_frac` of the example's valid length).

    rows: feats holds only these rows of the batch whose `lengths` are
    given (a data-parallel rank's part): the masks are drawn for the whole
    batch, the same on every rank, and this part's rows applied."""
    if freq_masks == 0 and time_masks == 0:
        return feats
    b = lengths.shape[0]
    t, f = feats.shape[1:]
    dev = feats.device
    part = slice(None) if rows is None else rows

    def uniform(n: int) -> torch.Tensor:
        return torch.rand((b, n), generator=generator, device=dev, dtype=torch.float32)

    masked = feats
    if freq_masks:
        fw = (uniform(freq_masks) * (freq_width + 1)).to(torch.int32)
        fs = (uniform(freq_masks) * torch.clamp(f - fw, min=1).float()).to(torch.int32)
        fmask = _interval_mask(f, fs, fw)                              # [B, F]
        masked = torch.where(fmask[part, None, :], mask_value, masked)
    if time_masks:
        length = lengths.to(torch.int32)[:, None]
        max_w = torch.clamp(length.float() * time_frac, min=1.0)
        tw = (uniform(time_masks) * (max_w + 1.0)).to(torch.int32)
        ts = (uniform(time_masks) * torch.clamp(length - tw, min=1).float()).to(torch.int32)
        tmask = _interval_mask(t, ts, tw)                              # [B, T]
        # never mask beyond the valid length (padding is already zero)
        tmask &= torch.arange(t, device=dev)[None, :] < length
        masked = torch.where(tmask[part, :, None], mask_value, masked)
    return masked
