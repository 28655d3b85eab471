"""FastConformer-CTC encoder as torch modules (inference).

Port of tilawa_tpu/models/fastconformer.py. Module and buffer names are the
flax parameter names, so a bundle maps onto `state_dict()` one leaf per key
(models/convert.py): `subsampling.conv_in.kernel`, `blocks.3.ff1.lin1.packed`,
`blocks.3.conv.bn.mean`, `ctc_head.scales`, ...

Numerics follow flax's rounding points in the compute dtype (bfloat16 for
the champion): Int4Dense rounds its f32 product to the dtype and then adds
the rounded bias; LayerNorm (eps 1e-6) takes its statistics in f32
(E[x²] - E[x]²) and casts its output; MaskedBatchNorm uses the running
stats in f32 (eps 1e-5); attention scores are divided in f32 (flax divides
the bf16 sum by a numpy float64 scalar, which promotes), keys are masked with
-1e30 and the softmax runs in f32 before the cast; the head log-softmax is
f32. Convolutions run in the dtype with the bias added after the rounded
conv output, as flax's nn.Conv does.

Int8Dense keeps flax's order: the bf16 product is rounded, then multiplied
by the bf16 column scales (int8_dense); quant="mixed" puts the feed-forward
pair (MIXED_INT4_NAMES) on Int4Dense and every other Dense on Int8Dense.

Only the inference path is ported: no dropout, SpecAugment, remat or batch
statistics updates.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tilawa_tpu_torch.ops.frontend import MelTables, log_mel_spectrogram, mel_tables
from tilawa_tpu_torch.ops.quant import (
    INT4_BLOCK,
    int4_matmul,
    int4_matmul_plain,
    int8_dense,
    int8_dense_plain,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
# Keys of a bundle's config.json that only training reads.
_TRAINING_ONLY = frozenset({
    "dropout", "scan_layers", "remat",
    "sa_freq_masks", "sa_freq_width", "sa_time_masks", "sa_time_frac",
})


@dataclasses.dataclass(frozen=True)
class FastConformerConfig:
    vocab_size: int = 1024            # labels; blank id == vocab_size
    n_mels: int = 80
    d_model: int = 512
    num_layers: int = 17
    num_heads: int = 8
    ff_expansion: int = 4
    conv_kernel: int = 9
    subsampling_channels: int = 256
    subsampling_factor: int = 8
    dtype: torch.dtype = torch.float32
    # Weight quantization for every Dense: None (fp), "int4", "int8" or
    # "mixed" (int4 feed-forward pair, int8 elsewhere).
    quant: str | None = None
    # The hand-written kernels (int4/int8 matmul, fused log-mel) for CUDA tensors;
    # False runs the plain PyTorch ops on any device, as the JAX package's
    # use_pallas=False runs pure XLA.
    use_pallas: bool = True

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def num_classes(self) -> int:
        return self.vocab_size + 1

    @classmethod
    def large(cls, **kw) -> "FastConformerConfig":
        """Production scale; bfloat16 compute."""
        base = dict(dtype=torch.bfloat16)
        base.update(kw)
        return cls(**base)

    @classmethod
    def small(cls, **kw) -> "FastConformerConfig":
        """Test-scale config: same topology, tiny dims."""
        base = dict(
            d_model=64, num_layers=2, num_heads=4, ff_expansion=2,
            subsampling_channels=32,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_json(cls, path: str | Path) -> "FastConformerConfig":
        """A bundle's config.json (tilawa_tpu train/checkpoint.py:load_config)."""
        raw = json.loads(Path(path).read_text())
        cfg = {k: v for k, v in raw.items() if k not in _TRAINING_ONLY}
        cfg["dtype"] = _DTYPES[cfg.get("dtype", "float32")]
        return cls(**cfg)


def subsampled_length(length, factor: int = 8):
    """Frame count after the striding conv stack (k=3, s=2, p=1 per stage)."""
    out = length
    for _ in range(int(np.log2(factor))):
        out = (out - 1) // 2 + 1
    return out


def _zeros(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype)


class Dense(nn.Module):
    """flax nn.Dense: kernel [K, N] (+ bias), all cast to the dtype."""

    def __init__(self, k: int, n: int, cfg: FastConformerConfig, use_bias: bool = True):
        super().__init__()
        self.dtype = cfg.dtype
        self.register_buffer("kernel", _zeros(k, n))
        self.register_buffer("bias", _zeros(n) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Int4Dense(nn.Module):
    """Dense over packed int4 weights: `packed` uint8 [K//2, N], `scales`
    f32 [ceil(K/32), N], optional `bias`; dequantized inside the matmul."""

    def __init__(self, k: int, n: int, cfg: FastConformerConfig, use_bias: bool = True):
        super().__init__()
        if k % 2:
            raise ValueError(f"int4 dense needs even fan-in, got {k}")
        self.cfg = cfg
        self.register_buffer("packed", _zeros(k // 2, n, dtype=torch.uint8))
        self.register_buffer("scales", _zeros(-(-k // INT4_BLOCK), n))
        self.register_buffer("bias", _zeros(n) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        matmul = int4_matmul if self.cfg.use_pallas else int4_matmul_plain
        y = matmul(x, self.packed, self.scales).to(self.cfg.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.cfg.dtype)
        return y


class Int8Dense(nn.Module):
    """Dense over int8 weights with per-output-column scales: `q` int8
    [K, N], `scales` f32 [N], optional `bias`. y = bf16(x @ q) * bf16(scales)
    in the dtype, then the bias (flax Int8Dense's order)."""

    def __init__(self, k: int, n: int, cfg: FastConformerConfig, use_bias: bool = True):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("q", _zeros(k, n, dtype=torch.int8))
        self.register_buffer("scales", _zeros(n))
        self.register_buffer("bias", _zeros(n) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        if dt == torch.bfloat16:
            dense = int8_dense if self.cfg.use_pallas else int8_dense_plain
            y = dense(x, self.q, self.scales)
        elif x.device.type == "cpu" or not self.cfg.use_pallas:
            # Other dtypes (the small f32 test configs) take flax's order in
            # that dtype; the kernel computes the bf16 model only.
            y = torch.matmul(x.to(dt), self.q.to(dt)) * self.scales.to(dt)
        else:
            raise ValueError(f"the int8 kernel computes bfloat16 models, not {dt}")
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


# quant="mixed": module names whose kernels go int4 (the FFN bulk); every
# other Dense goes int8.
MIXED_INT4_NAMES = frozenset({"lin1", "lin2"})


def make_dense(
    cfg: FastConformerConfig, k: int, n: int, use_bias: bool = True, name: str = ""
) -> nn.Module:
    if cfg.quant == "int4":
        return Int4Dense(k, n, cfg, use_bias)
    if cfg.quant == "int8":
        return Int8Dense(k, n, cfg, use_bias)
    if cfg.quant == "mixed":
        cls = Int4Dense if name in MIXED_INT4_NAMES else Int8Dense
        return cls(k, n, cfg, use_bias)
    if cfg.quant is None:
        return Dense(k, n, cfg, use_bias)
    raise ValueError(f"unknown quant mode {cfg.quant!r}")


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(dtype=...): f32 statistics, eps 1e-6, cast out."""

    def __init__(self, d: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.register_buffer("scale", torch.ones(d))
        self.register_buffer("bias", _zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


class MaskedBatchNorm(nn.Module):
    """Inference BatchNorm over (batch, time) with the running stats."""

    def __init__(self, c: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", _zeros(c))
        self.register_buffer("mean", _zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.mean) * torch.rsqrt(self.var + self.eps)
        return (y * self.scale + self.bias).to(self.dtype)


class Conv(nn.Module):
    """flax nn.Conv in the dtype: kernel OIHW (2-D) or OIW (1-D), the bias
    added to the rounded conv output."""

    def __init__(self, c_in: int, c_out: int, kernel: tuple[int, ...],
                 dtype: torch.dtype, stride: int = 1, padding: int = 0,
                 groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.groups = stride, padding, groups
        self.register_buffer("kernel", _zeros(c_out, c_in // groups, *kernel))
        self.register_buffer("bias", _zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if self.kernel.dim() == 4 else F.conv1d
        y = conv(x.to(self.dtype), self.kernel.to(self.dtype), None,
                 self.stride, self.padding, 1, self.groups)
        shape = (1, -1) + (1,) * (y.dim() - 2)
        return y + self.bias.to(self.dtype).view(shape)


def _stride2_len(length):
    return (length - 1) // 2 + 1


class ConvSubsampling(nn.Module):
    """Depthwise-striding 8x subsampling; padded time is re-zeroed after
    every strided stage so stride-2 taps never read bias-polluted padding."""

    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        ch, dt = cfg.subsampling_channels, cfg.dtype
        self.conv_in = Conv(1, ch, (3, 3), dt, stride=2, padding=1)
        self.stages = int(np.log2(cfg.subsampling_factor)) - 1
        for i in range(self.stages):
            self.add_module(f"dw_conv_{i}", Conv(ch, ch, (3, 3), dt, stride=2, padding=1, groups=ch))
            self.add_module(f"pw_conv_{i}", Conv(ch, ch, (1, 1), dt))
        f = cfg.n_mels
        for _ in range(self.stages + 1):
            f = _stride2_len(f)
        self.proj = make_dense(cfg, f * ch, cfg.d_model)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        # x [B, T, n_mels] f32 → NCHW [B, 1, T, F]; lengths [B] frame counts.
        def time_mask(h, lens):
            keep = torch.arange(h.shape[2], device=h.device)[None, :] < lens[:, None]
            return torch.where(keep[:, None, :, None], h, 0.0)

        h = F.relu(self.conv_in(x[:, None]))
        lens = _stride2_len(lengths)
        h = time_mask(h, lens)
        for i in range(self.stages):
            h = getattr(self, f"dw_conv_{i}")(h)
            h = F.relu(getattr(self, f"pw_conv_{i}")(h))
            lens = _stride2_len(lens)
            h = time_mask(h, lens)
        b, c, t, f = h.shape
        # flax flattens channels-last: [B, T, F, C] → [B, T, F*C]
        h = h.permute(0, 2, 3, 1).reshape(b, t, f * c)
        return self.proj(h)


class FeedForward(nn.Module):
    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.LayerNorm_0 = LayerNorm(d, cfg.dtype)
        self.lin1 = make_dense(cfg, d, d * cfg.ff_expansion, name="lin1")
        self.lin2 = make_dense(cfg, d * cfg.ff_expansion, d, name="lin2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.silu(self.lin1(self.LayerNorm_0(x))))


def rel_positional_encoding(t: int, d_model: int) -> np.ndarray:
    """Sinusoidal embeddings for relative positions T-1 .. -(T-1),
    indexed so row k encodes relative position (T-1) - k."""
    positions = np.arange(t - 1, -t, -1, dtype=np.float64)  # [2T-1]
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_model, 2) / d_model))
    ang = positions[:, None] * inv_freq[None, :]
    emb = np.zeros((2 * t - 1, d_model), dtype=np.float32)
    emb[:, 0::2] = np.sin(ang)
    emb[:, 1::2] = np.cos(ang)
    return emb


def _rel_shift(qp: torch.Tensor, t: int) -> torch.Tensor:
    """[B,H,T,2T-1] → [B,H,T,T] with out[..., i, j] = qp[..., i, T-1-i+j]
    (the Transformer-XL pad-reshape)."""
    b, h = qp.shape[:2]
    x = F.pad(qp, (1, 0))                                   # [B,H,T,2T]
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:, :]              # [B,H,2T-1,T]
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPosSelfAttention(nn.Module):
    """Transformer-XL relative-position MHSA with u/v biases."""

    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        self.cfg = cfg
        for name in ("q", "k", "v"):
            self.add_module(name, make_dense(cfg, d, d))
        self.pos = make_dense(cfg, d, d, use_bias=False)
        self.out = make_dense(cfg, d, d)
        self.register_buffer("bias_u", _zeros(h, d // h))
        self.register_buffer("bias_v", _zeros(h, d // h))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [B, T, D], mask [B, T, 1], pos [2T-1, D] relative-position
        embeddings in the dtype (rel_positional_encoding)."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, t, d = x.shape
        h, dh = cfg.num_heads, d // cfg.num_heads

        q = self.q(x).view(b, t, h, dh)
        k = self.k(x).view(b, t, h, dh)
        v = self.v(x).view(b, t, h, dh)
        p = self.pos(pos).view(2 * t - 1, h, dh)

        qu = (q + self.bias_u.to(dt)).transpose(1, 2)          # [B,H,T,dh]
        qv = (q + self.bias_v.to(dt)).transpose(1, 2)
        content = torch.matmul(qu, k.permute(0, 2, 3, 1))       # [B,H,T,T]
        qp = torch.matmul(qv, p.permute(1, 2, 0))               # [B,H,T,2T-1]
        scores = (content + _rel_shift(qp, t)).float() / math.sqrt(dh)

        key_mask = mask[:, None, None, :, 0]                    # [B,1,1,T]
        scores = torch.where(key_mask, scores, -1e30)
        attn = torch.softmax(scores, dim=-1).to(dt)
        out = torch.matmul(attn, v.transpose(1, 2))             # [B,H,T,dh]
        return self.out(out.transpose(1, 2).reshape(b, t, d))


class ConvModule(nn.Module):
    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.LayerNorm_0 = LayerNorm(d, cfg.dtype)
        self.pw1 = make_dense(cfg, d, 2 * d)
        pad = (cfg.conv_kernel - 1) // 2
        self.dw = Conv(d, d, (cfg.conv_kernel,), cfg.dtype, padding=pad, groups=d)
        self.bn = MaskedBatchNorm(d, cfg.dtype)
        self.pw2 = make_dense(cfg, d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = F.glu(self.pw1(self.LayerNorm_0(x)), dim=-1)
        h = torch.where(mask, h, 0.0)  # keep padded frames out of the conv taps
        h = self.dw(h.transpose(1, 2)).transpose(1, 2)
        return self.pw2(F.silu(self.bn(h)))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        self.ff1 = FeedForward(cfg)
        self.attn_ln = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = RelPosSelfAttention(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(cfg)
        self.final_ln = LayerNorm(cfg.d_model, cfg.dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ff1(x)
        x = x + self.attn(self.attn_ln(x), mask, pos)
        x = x + self.conv(x, mask)
        x = x + 0.5 * self.ff2(x)
        return self.final_ln(x)


class FastConformerCTC(nn.Module):
    """Raw audio [B, N] f32 + sample counts [B] → (CTC log-probs
    [B, T_enc, V] f32, encoder frame counts [B] int32)."""

    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        # The reference runs f32 convolutions and products in full f32;
        # PyTorch's cuDNN default for f32 convolutions is TF32. Process-wide.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        for name, table in mel_tables()._asdict().items():
            self.register_buffer(f"mel_{name}", table, persistent=False)
        self.subsampling = ConvSubsampling(cfg)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.num_layers))
        self.ctc_head = make_dense(cfg, cfg.d_model, cfg.num_classes)

    def tables(self) -> MelTables:
        return MelTables(self.mel_window, self.mel_fb, self.mel_dft_real, self.mel_dft_imag)

    def forward(
        self, audio: torch.Tensor, lengths: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        feats, feat_lengths = log_mel_spectrogram(
            audio, lengths, self.tables(), use_kernel=cfg.use_pallas
        )
        x = self.subsampling(feats, feat_lengths)
        enc_lengths = subsampled_length(feat_lengths, cfg.subsampling_factor)
        t = x.shape[1]
        mask = (torch.arange(t, device=x.device)[None, :] < enc_lengths[:, None])[..., None]
        x = torch.where(mask, x, 0.0)
        # Built once per forward on the host in float64 like the reference,
        # uploaded once: a pageable upload inside every block would make the
        # host wait for the device 17 times per forward.
        pos = torch.from_numpy(rel_positional_encoding(t, cfg.d_model)).to(x.device, cfg.dtype)
        for block in self.blocks:
            x = block(x, mask, pos)
        logits = self.ctc_head(x)
        return torch.log_softmax(logits.float(), dim=-1), enc_lengths.to(torch.int32)
