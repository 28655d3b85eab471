"""FastConformer-CTC encoder as torch modules: inference and training.

Port of tilawa_tpu/models/fastconformer.py. Module, parameter and buffer
names are the flax parameter names, so a bundle maps onto `state_dict()` one
leaf per key (models/convert.py): `subsampling.conv_in.kernel`,
`blocks.3.ff1.lin1.packed`, `blocks.3.conv.bn.mean`, `ctc_head.scales`, ...
Float leaves (Dense, Conv, LayerNorm and BatchNorm scale and bias, the
attention's u/v biases) are f32 `nn.Parameter`s, the master weights that
training updates; quantized weights and their scales, and BatchNorm's
running `mean`/`var`, are buffers. The serve paths call the model under
`torch.inference_mode()`, so the Parameters build no autograd graph there.

Numerics follow flax's rounding points in the compute dtype (bfloat16 for
the champion): Int4Dense rounds its f32 product to the dtype and then adds
the rounded bias (int4_dense, one launch on the card); LayerNorm (eps 1e-6)
takes its statistics in f32 (E[x²] - E[x]²) and casts its output;
MaskedBatchNorm normalizes in f32 (eps 1e-5); attention scores are divided
in f32 (flax divides the bf16 sum by a numpy float64 scalar, which
promotes), keys are masked with -1e30 and the softmax runs in f32 before
the cast; the head log-softmax is f32. Convolutions run in the dtype with
the bias added after the rounded conv output, as flax's nn.Conv does.

Int8Dense keeps flax's order: the bf16 product is rounded, then multiplied
by the bf16 column scales, then the rounded bias is added (int8_dense, one
launch on the card); quant="mixed" puts the feed-forward pair
(MIXED_INT4_NAMES) on Int4Dense and every other Dense on Int8Dense.

Training mode mirrors flax's two flags, which stay apart:
`deterministic=False` turns on dropout (flax's nn.Dropout: keep with
probability 1-p, scale by 1/(1-p), in the dtype) and SpecAugment
(ops/specaug.py); `use_running_average=False` normalizes BatchNorm with the
batch's masked mean and biased variance in f32 over (B, T) and moves the
running stats by momentum 0.99. Every random draw comes from the explicit
`generator`, and a block's dropout masks are drawn before the block runs,
so `remat=True` (each block under torch.utils.checkpoint) recomputes with
the same masks. `scan_layers` is flax's compile-time knob and changes
nothing here: bundles are always written with the scanned layout.
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
from torch.utils.checkpoint import checkpoint

from tilawa_tpu_torch.device import upload
from tilawa_tpu_torch.ops.frontend import N_MELS, MelTables, log_mel_spectrogram, mel_tables
from tilawa_tpu_torch.ops.specaug import spec_augment
from tilawa_tpu_torch.ops.quant import (
    INT4_BLOCK,
    int4_dense,
    int4_dense_plain,
    int8_dense,
    int8_dense_plain,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


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
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32
    # flax's lax.scan over the depth axis; the torch modules are the same
    # either way (kept so that config.json round-trips with the JAX package).
    scan_layers: bool = True
    # Weight quantization for every Dense: None (fp), "int4", "int8" or
    # "mixed" (int4 feed-forward pair, int8 elsewhere).
    quant: str | None = None
    # The hand-written kernels (int4/int8 matmul, fused log-mel) for CUDA tensors;
    # False runs the plain PyTorch ops on any device, as the JAX package's
    # use_pallas=False runs pure XLA.
    use_pallas: bool = True
    # Recompute each conformer block in the backward pass (training only).
    remat: bool = False
    # SpecAugment on the mel features, applied only when deterministic=False.
    sa_freq_masks: int = 0
    sa_freq_width: int = 27
    sa_time_masks: int = 0
    sa_time_frac: float = 0.05

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
    def phoneme(cls, **kw) -> "FastConformerConfig":
        """69-token Buckwalter phoneme CTC head (reference:
        experiments/fastconformer-phoneme/run.py:43-55, blank at 69)."""
        base = dict(vocab_size=69)
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
        cfg = json.loads(Path(path).read_text())
        cfg["dtype"] = _DTYPES[cfg.get("dtype", "float32")]
        return cls(**cfg)

    def to_dict(self) -> dict:
        """Every field, the dtype by name (train/checkpoint.py:save_variables)."""
        cfg = dataclasses.asdict(self)
        cfg["dtype"] = str(self.dtype).removeprefix("torch.")
        return cfg

    def to_json(self) -> str:
        """config.json as the JAX package writes it, key for key."""
        return json.dumps(self.to_dict(), indent=2)


def subsampled_length(length, factor: int = 8):
    """Frame count after the striding conv stack (k=3, s=2, p=1 per stage)."""
    out = length
    for _ in range(int(np.log2(factor))):
        out = (out - 1) // 2 + 1
    return out


def _zeros(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype)


def _param(t: torch.Tensor | None) -> nn.Parameter | None:
    return None if t is None else nn.Parameter(t)


def _local(t: torch.Tensor | None) -> torch.Tensor | None:
    """A variable's part on this rank: for a DTensor variable (a model
    sharded by parallel/sharding.py) the plain tensor that shard_variables
    made once over its local storage (`rank_part`), else the variable
    itself."""
    return getattr(t, "rank_part", t)


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """flax nn.Dropout with a drawn keep mask: x / (1 - rate) where kept,
    0 elsewhere, in x's dtype; keep=None is the identity."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Dense(nn.Module):
    """flax nn.Dense: kernel [K, N] (+ bias), all cast to the dtype.

    On a mesh (parallel/sharding.py sets `split` and `axes`) a "col" layer
    holds its columns of the kernel: it takes its input through
    axes.model_copy and adds its own columns of the bias; a "row" layer
    holds its rows and gets its part of x's columns: it sums the partial
    product over "model", then adds the whole bias."""

    def __init__(self, k: int, n: int, cfg: FastConformerConfig, use_bias: bool = True):
        super().__init__()
        self.dtype = cfg.dtype
        self.kernel = _param(_zeros(k, n))
        self.bias = _param(_zeros(n) if use_bias else None)
        self.split = None
        self.axes = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = _local(self.kernel)
        if self.split == "col":
            x = self.axes.model_copy(x)
        y = torch.matmul(x.to(self.dtype), kernel.to(self.dtype))
        if self.split == "row":
            y = self.axes.model_sum(y)
        if self.bias is not None:
            bias = _local(self.bias)
            if self.split == "col":
                bias = bias[self.axes.model_slice(bias.shape[0])]
            y = y + bias.to(self.dtype)
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
        dense = int4_dense if self.cfg.use_pallas else int4_dense_plain
        return dense(x, self.packed, self.scales, self.bias, self.cfg.dtype)


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
            return dense(x, self.q, self.scales, self.bias)
        if x.device.type != "cpu" and self.cfg.use_pallas:
            raise ValueError(f"the int8 kernel computes bfloat16 models, not {dt}")
        # Other dtypes (the small f32 test configs) take flax's order in
        # that dtype; the kernel computes the bf16 model only.
        y = torch.matmul(x.to(dt), self.q.to(dt)) * self.scales.to(dt)
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
        self.scale = _param(torch.ones(d))
        self.bias = _param(_zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * _local(self.scale)) + _local(self.bias)
        return y.to(self.dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) that ignores padded frames. With
    `batch_stats` None it normalizes with the running stats; with a list it
    normalizes with the batch's masked mean and biased variance (f32) and
    appends them, detached, for update_running. On a mesh (`axes` set by
    parallel/sharding.py) x holds this data rank's rows: the masked sum and
    count, then the centred square sum, are summed over "data", so every
    rank normalizes with (and keeps) the global batch's statistics."""

    def __init__(self, c: int, dtype: torch.dtype, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum
        self.scale = _param(torch.ones(c))
        self.bias = _param(_zeros(c))
        self.register_buffer("mean", _zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.axes = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                batch_stats: list | None = None) -> torch.Tensor:
        """x [B, T, C], mask [B, T, 1] bool."""
        if batch_stats is None:
            mean, var = _local(self.mean), _local(self.var)
        else:
            total = (lambda s: s) if self.axes is None else self.axes.data_sum
            cnt = torch.clamp(total(mask.sum()), min=1).float()
            xf = x.float()
            mean = total(torch.where(mask, xf, 0.0).sum(dim=(0, 1))) / cnt
            var = total((torch.where(mask, xf - mean, 0.0) ** 2).sum(dim=(0, 1))) / cnt
            batch_stats.append((mean.detach(), var.detach()))
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * _local(self.scale) + _local(self.bias)).to(self.dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = momentum·ra + (1 - momentum)·batch, as flax's MaskedBatchNorm."""
        ra_mean, ra_var = _local(self.mean), _local(self.var)
        ra_mean.copy_(self.momentum * ra_mean + (1 - self.momentum) * mean)
        ra_var.copy_(self.momentum * ra_var + (1 - self.momentum) * var)


class Conv(nn.Module):
    """flax nn.Conv in the dtype: kernel OIHW (2-D) or OIW (1-D), the bias
    added to the rounded conv output."""

    def __init__(self, c_in: int, c_out: int, kernel: tuple[int, ...],
                 dtype: torch.dtype, stride: int = 1, padding: int = 0,
                 groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.groups = stride, padding, groups
        self.kernel = _param(_zeros(c_out, c_in // groups, *kernel))
        self.bias = _param(_zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = _local(self.kernel)
        conv = F.conv2d if kernel.dim() == 4 else F.conv1d
        y = conv(x.to(self.dtype), kernel.to(self.dtype), None,
                 self.stride, self.padding, 1, self.groups)
        shape = (1, -1) + (1,) * (y.dim() - 2)
        return y + _local(self.bias).to(self.dtype).view(shape)


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
        f = N_MELS   # the frontend's width (flax infers it; cfg.n_mels only sizes FLOPs)
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
        self.rate = cfg.dropout
        self.LayerNorm_0 = LayerNorm(d, cfg.dtype)
        self.lin1 = make_dense(cfg, d, d * cfg.ff_expansion, name="lin1")
        self.lin2 = make_dense(cfg, d * cfg.ff_expansion, d, name="lin2")

    def forward(self, x: torch.Tensor, keep=(None, None)) -> torch.Tensor:
        h = dropout(F.silu(self.lin1(self.LayerNorm_0(x))), keep[0], self.rate)
        return dropout(self.lin2(h), keep[1], self.rate)


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


def _row_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, H, M, K] @ b ([B, H, K, N], or [H, K, N] shared by the rows),
    one batch row at a time. cuBLAS picks its algorithm, and with it the
    order of each output's sums, from the batch count: on the H100 the
    attention products at T = 50 and 100 frames round a row batched with
    others differently from the row alone. Row by row every row is the
    same [H, M, K] @ [H, K, N] call whatever B is."""
    if a.shape[0] == 1:
        return torch.matmul(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        # training: out= has no autograd, and no row needs to match a lone
        # forward; one batched product (the per-row calls cost a training
        # step ~2,400 launches at B=16)
        return torch.matmul(a, b)
    out = torch.empty(a.shape[:-1] + b.shape[-1:], dtype=a.dtype, device=a.device)
    for i in range(a.shape[0]):
        torch.matmul(a[i], b[i] if b.dim() == 4 else b, out=out[i])
    return out


class RelPosSelfAttention(nn.Module):
    """Transformer-XL relative-position MHSA with u/v biases. On a mesh
    (`axes` set by parallel/sharding.py) q/k/v/pos give this model rank's
    heads, which add their own rows of the replicated u/v biases."""

    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        self.cfg = cfg
        for name in ("q", "k", "v"):
            self.add_module(name, make_dense(cfg, d, d))
        self.pos = make_dense(cfg, d, d, use_bias=False)
        self.out = make_dense(cfg, d, d)
        self.bias_u = _param(_zeros(h, d // h))
        self.bias_v = _param(_zeros(h, d // h))
        self.axes = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, T, D], mask [B, T, 1], pos [2T-1, D] relative-position
        embeddings in the dtype (rel_positional_encoding); keep [B, H, T, T]
        the attention-weight dropout mask."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, t, d = x.shape
        h, dh = cfg.num_heads, d // cfg.num_heads
        bias_u, bias_v = _local(self.bias_u), _local(self.bias_v)
        if self.axes is not None:   # this model rank's heads
            heads = self.axes.model_slice(h)
            h = heads.stop - heads.start
            bias_u, bias_v = bias_u[heads], bias_v[heads]

        q = self.q(x).view(b, t, h, dh)
        k = self.k(x).view(b, t, h, dh)
        v = self.v(x).view(b, t, h, dh)
        p = self.pos(pos).view(2 * t - 1, h, dh)

        qu = (q + bias_u.to(dt)).transpose(1, 2)               # [B,H,T,dh]
        qv = (q + bias_v.to(dt)).transpose(1, 2)
        content = _row_matmul(qu, k.permute(0, 2, 3, 1))        # [B,H,T,T]
        qp = _row_matmul(qv, p.permute(1, 2, 0))                # [B,H,T,2T-1]
        scores = (content + _rel_shift(qp, t)).float() / math.sqrt(dh)

        key_mask = mask[:, None, None, :, 0]                    # [B,1,1,T]
        scores = torch.where(key_mask, scores, -1e30)
        attn = dropout(torch.softmax(scores, dim=-1).to(dt), keep, cfg.dropout)
        out = _row_matmul(attn, v.transpose(1, 2))              # [B,H,T,dh]
        return self.out(out.transpose(1, 2).reshape(b, t, h * dh))


class ConvModule(nn.Module):
    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.rate = cfg.dropout
        self.LayerNorm_0 = LayerNorm(d, cfg.dtype)
        self.pw1 = make_dense(cfg, d, 2 * d)
        pad = (cfg.conv_kernel - 1) // 2
        self.dw = Conv(d, d, (cfg.conv_kernel,), cfg.dtype, padding=pad, groups=d)
        self.bn = MaskedBatchNorm(d, cfg.dtype)
        self.pw2 = make_dense(cfg, d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, keep: torch.Tensor | None = None,
                batch_stats: list | None = None) -> torch.Tensor:
        h = F.glu(self.pw1(self.LayerNorm_0(x)), dim=-1)
        h = torch.where(mask, h, 0.0)  # keep padded frames out of the conv taps
        h = self.dw(h.transpose(1, 2)).transpose(1, 2)
        return dropout(self.pw2(F.silu(self.bn(h, mask, batch_stats))), keep, self.rate)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        self.ff1 = FeedForward(cfg)
        self.attn_ln = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = RelPosSelfAttention(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(cfg)
        self.final_ln = LayerNorm(cfg.d_model, cfg.dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                keep: tuple | None = None, batch_stats: list | None = None) -> torch.Tensor:
        """keep: the block's six dropout masks (draw_block_masks) or None;
        batch_stats: a list to normalize BatchNorm with the batch's stats."""
        k = keep or (None,) * 6
        x = x + 0.5 * self.ff1(x, k[0:2])
        x = x + self.attn(self.attn_ln(x), mask, pos, k[2])
        x = x + self.conv(x, mask, k[3], batch_stats)
        x = x + 0.5 * self.ff2(x, k[4:6])
        return self.final_ln(x)


def draw_block_masks(cfg: FastConformerConfig, b: int, t: int,
                     generator: torch.Generator, device: torch.device, axes=None) -> tuple:
    """One block's dropout keep masks, in the order the block applies them:
    ff1 (hidden, out), attention weights, conv out, ff2 (hidden, out).
    With `axes` (a mesh), b is the global batch: the masks are drawn at the
    global shape and this rank's rows, hidden columns and heads kept."""
    d, hid = cfg.d_model, cfg.d_model * cfg.ff_expansion
    shapes = ((b, t, hid), (b, t, d), (b, cfg.num_heads, t, t), (b, t, d), (b, t, hid), (b, t, d))
    keep = 1.0 - cfg.dropout
    masks = tuple(
        torch.rand(s, generator=generator, device=device) < keep for s in shapes
    )
    if axes is None:
        return masks
    r, cols, heads = axes.rows(b), axes.model_slice(hid), axes.model_slice(cfg.num_heads)
    return (masks[0][r, :, cols], masks[1][r], masks[2][r, heads], masks[3][r],
            masks[4][r, :, cols], masks[5][r])


class FastConformerCTC(nn.Module):
    """Raw audio [B, N] f32 + sample counts [B] → (CTC log-probs
    [B, T_enc, V] f32, encoder frame counts [B] int32).

    On a mesh (parallel/sharding.py shard_variables sets `axes`) audio and
    lengths are this data rank's rows of a global batch split evenly over
    "data", and so are the outputs; the frontend and the subsampling run on
    them alone, and the random masks are drawn for the global batch."""

    def __init__(self, cfg: FastConformerConfig):
        super().__init__()
        # The reference runs f32 convolutions and products in full f32;
        # PyTorch's cuDNN default for f32 convolutions is TF32. And its
        # jitted step is bitwise repeatable, where cuDNN may pick a weight
        # gradient algorithm that sums with atomics. Process-wide.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        self.cfg = cfg
        for name, table in mel_tables()._asdict().items():
            self.register_buffer(f"mel_{name}", table, persistent=False)
        self.subsampling = ConvSubsampling(cfg)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.num_layers))
        self.ctc_head = make_dense(cfg, cfg.d_model, cfg.num_classes)
        self.axes = None

    def tables(self) -> MelTables:
        return MelTables(*(getattr(self, f"mel_{name}") for name in MelTables._fields))

    def forward(
        self, audio: torch.Tensor, lengths: torch.Tensor, *,
        deterministic: bool = True, use_running_average: bool = True,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """deterministic=False applies dropout and SpecAugment with draws
        from `generator` (on the audio's device); use_running_average=False
        normalizes BatchNorm with the batch's statistics and updates the
        running stats (flax's mutable batch_stats)."""
        cfg = self.cfg
        if cfg.quant is not None and torch.is_grad_enabled() and (
            not deterministic or not use_running_average
        ):
            raise ValueError(f"a quantized ({cfg.quant}) model cannot be trained; "
                             "dequantize it (train/quantize.py) first")
        random = not deterministic and (
            cfg.dropout > 0 or cfg.sa_freq_masks or cfg.sa_time_masks)
        if random and generator is None:
            raise ValueError("deterministic=False needs a torch.Generator for its draws")
        feats, feat_lengths = log_mel_spectrogram(
            audio, lengths, self.tables(), use_kernel=cfg.use_pallas
        )
        axes = self.axes
        if not deterministic and (cfg.sa_freq_masks or cfg.sa_time_masks):
            rows = None if axes is None else axes.rows(axes.data_size * feats.shape[0])
            feats = spec_augment(
                feats, feat_lengths if axes is None else axes.data_gather(feat_lengths),
                generator,
                freq_masks=cfg.sa_freq_masks, freq_width=cfg.sa_freq_width,
                time_masks=cfg.sa_time_masks, time_frac=cfg.sa_time_frac, rows=rows,
            )
        x = self.subsampling(feats, feat_lengths)
        enc_lengths = subsampled_length(feat_lengths, cfg.subsampling_factor)
        t = x.shape[1]
        mask = (torch.arange(t, device=x.device)[None, :] < enc_lengths[:, None])[..., None]
        x = torch.where(mask, x, 0.0)
        # Built once per forward on the host in float64 like the reference,
        # uploaded once without a host sync (device.upload: pinned, non-
        # blocking), then cast on the device.
        pos = upload(rel_positional_encoding(t, cfg.d_model), x.device).to(cfg.dtype)
        drop = not deterministic and cfg.dropout > 0
        b = x.shape[0] if axes is None else x.shape[0] * axes.data_size
        for block in self.blocks:
            keep = draw_block_masks(cfg, b, t, generator, x.device, axes) if drop else None
            stats = None if use_running_average else []
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, mask, pos, keep, stats, use_reentrant=False)
            else:
                x = block(x, mask, pos, keep, stats)
            if stats:
                # the first forward's statistics; a remat recompute appends
                # its own to this list after the update and is ignored
                block.conv.bn.update_running(*stats[0])
        logits = self.ctc_head(x)
        return torch.log_softmax(logits.float(), dim=-1), enc_lengths.to(torch.int32)


def count_params(tree) -> int:
    """Elements over every leaf of a nested dict of arrays: a bundle's
    variables as the port loads them (numpy leaves), packed int4 bytes and
    scales counted as stored, as the JAX package's count_params counts the
    same tree's leaves."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(np.prod(np.shape(tree)))


def forward_flops(cfg: FastConformerConfig, audio_seconds: float) -> float:
    """Analytic matmul FLOPs of one encoder forward over `audio_seconds`
    of 16 kHz audio (multiply+add counted as 2). Used for the bench's MFU
    estimate against the H100 SXM's dense bf16 rate; conv-subsampling and
    the T^2 attention-score terms are included, elementwise/norm work is
    not (negligible against the matmuls)."""
    d = cfg.d_model
    t_mel = audio_seconds * 100.0                    # 160-sample hop
    t_enc = t_mel / cfg.subsampling_factor
    ch = cfg.subsampling_channels
    # dw-striding stages: pointwise-ish channel mixing at T/2, T/4, T/8
    sub = 2 * (t_mel / 2 * 9 * cfg.n_mels * ch
               + t_mel / 4 * 9 * ch * ch
               + t_mel / 8 * 9 * ch * ch)
    proj = 2 * t_enc * (ch * cfg.n_mels // cfg.subsampling_factor) * d
    ff = 2 * 2 * (2 * d * cfg.ff_expansion * d)       # macaron pair / frame
    attn_proj = 2 * 5 * d * d                         # q,k,v,pos,out / frame
    conv = 2 * (d * 2 * d + cfg.conv_kernel * d + d * d)
    per_frame = ff + attn_proj + conv
    scores = 4 * t_enc * t_enc * d * cfg.num_layers   # qk^T + att*v
    layers = cfg.num_layers * per_frame * t_enc + scores
    head = 2 * t_enc * d * (cfg.vocab_size + 1)
    return float(sub + proj + layers + head)
