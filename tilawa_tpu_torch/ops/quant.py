"""Int4/int8 weight quantization and the quantized matmuls.

Port of tilawa_tpu/ops/quant.py. Layout (int4): weights [K, N] are
split-half packed along K — byte row k2 holds k = k2 in the low nibble and
k = k2 + K/2 in the high nibble. Scales are symmetric, per (32-row K block,
output column). Layout (int8): q int8 [K, N] with one f32 scale per output
column.

Each wrapper launches its hand-written CUDA kernel for a CUDA tensor and
uses its plain version for a CPU tensor; the plain version is also what
the kernel is held against on the card. All are instances of one
tensor-core body (csrc/quant_matmul.cuh), acc = bf16(x) @ bf16(W) in f32:

  int4_matmul   csrc/int4_matmul.cu   f32 acc, W = bf16(unpack(q4) * scale)
  int4_dense    csrc/int4_matmul.cu   Int4Dense: bf16(bf16(acc) + bf16(bias))
  int8_matmul   csrc/int8_matmul.cu   f32 acc, W = bf16(q * scale) (scale in W)
  int8_dense    csrc/int8_matmul.cu   Int8Dense: W = q, then
                                      bf16(bf16(bf16(acc) * bf16(scale)) + bf16(bias))

Each output row's f32 sum order depends on K and N only (k_splits), so a
row comes out bitwise the same whatever the number of rows launched.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tilawa_tpu_torch.ops import kernels

INT4_BLOCK = 32  # K rows per scale group (MatMulNBits default block_size)


# --------------------------------------------------------------------------
# Packing / unpacking (host-side, numpy; copied from the JAX package)
# --------------------------------------------------------------------------

def pack_int4(w: np.ndarray, block: int = INT4_BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """[K, N] float → (packed uint8 [K//2, N], scales f32 [ceil(K/block), N]).

    Symmetric per-(block, column) quantization to [-7, 7]; K must be even
    and block must divide K/2 (both hold for every matmul in the model
    after padding).
    """
    w = np.asarray(w, dtype=np.float32)
    k, n = w.shape
    if k % 2:
        raise ValueError(f"K must be even, got {k}")
    kb = -(-k // block)
    pad_k = kb * block - k
    if pad_k:
        w = np.concatenate([w, np.zeros((pad_k, n), np.float32)], axis=0)
        k = w.shape[0]
    if (k // 2) % block and kb > 1:
        raise ValueError(f"block {block} must divide K/2 = {k // 2}")

    grouped = w.reshape(kb, block, n)
    scales = np.abs(grouped).max(axis=1) / 7.0  # [KB, N]
    scales = np.maximum(scales, 1e-12).astype(np.float32)
    q = np.clip(np.rint(grouped / scales[:, None, :]), -7, 7).astype(np.int8)
    q = q.reshape(k, n)

    half = k // 2
    lo = q[:half] & 0xF
    hi = q[half:] & 0xF
    packed = (lo | (hi << 4)).astype(np.uint8)
    return packed, scales


def unpack_int4(
    packed: np.ndarray, scales: np.ndarray, block: int = INT4_BLOCK
) -> np.ndarray:
    """Inverse of pack_int4 → dequantized f32 [K, N]."""
    packed = np.asarray(packed)
    lo = ((packed & 0xF).astype(np.int8) ^ 8) - 8
    hi = ((packed >> 4).astype(np.int8) ^ 8) - 8
    q = np.concatenate([lo, hi], axis=0).astype(np.float32)  # [K, N]
    k = q.shape[0]
    rep = np.repeat(np.asarray(scales, np.float32), block, axis=0)[:k]
    return q * rep


def quantize_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[..., K, N] float → (int8 values, per-output-column f32 scales [..., N]).
    Symmetric per-channel."""
    w = np.asarray(w, dtype=np.float32)
    scales = np.maximum(np.abs(w).max(axis=-2) / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(w / scales[..., None, :]), -127, 127).astype(np.int8)
    return q, scales


def dequantize_int8(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return np.asarray(q, np.float32) * np.asarray(scales, np.float32)[..., None, :]


# --------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors; the kernels' oracles on the card)
# --------------------------------------------------------------------------

def _unpack_int4_torch(
    packed: torch.Tensor, scales: torch.Tensor, block: int
) -> torch.Tensor:
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    q = torch.cat([lo, hi], dim=0).to(torch.float32)              # [K, N]
    rep = torch.repeat_interleave(scales, block, dim=0)[: q.shape[0]]
    return q * rep


def int4_matmul_plain(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
    block: int = INT4_BLOCK,
) -> torch.Tensor:
    """x [..., M, K] @ bf16(dequant(packed, scales)) → f32 [..., M, N], with
    x rounded to bf16 and f32 accumulation (tilawa_tpu int4_matmul_xla).
    bf16 products are exact in f32, so an f32 matmul of the rounded operands
    is the bf16-in/f32-accumulate product."""
    w = _unpack_int4_torch(packed, scales, block).to(torch.bfloat16).float()
    return torch.matmul(x.to(torch.bfloat16).float(), w)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [..., M, K] @ bf16(q [K, N] * scales [N]) → f32 [..., M, N], x
    rounded to bf16, f32 accumulation (tilawa_tpu int8_matmul_xla)."""
    w = (q.to(torch.float32) * scales).to(torch.bfloat16).float()
    return torch.matmul(x.to(torch.bfloat16).float(), w)


def int8_dense_plain(
    x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Int8Dense's order in bf16: (bf16(x) @ bf16(q)) rounded to bf16, then
    times bf16(scales) rounded to bf16, then plus bf16(bias) rounded to bf16
    → bf16 [..., M, N]. The products and sums are f32 of the bf16 operands
    (exact products), so each bf16 step rounds once, as a bf16 matmul with
    f32 accumulation and a bf16 multiply and add do."""
    acc = torch.matmul(x.to(torch.bfloat16).float(), q.to(torch.float32))
    y = (acc.to(torch.bfloat16).float() * scales.to(torch.bfloat16).float()).to(torch.bfloat16)
    if bias is not None:
        y = y + bias.to(torch.bfloat16)
    return y


def int4_dense_plain(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
    bias: torch.Tensor | None = None, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Int4Dense (flax's order): the f32 product cast to `dtype`, then plus
    the bias cast to `dtype`."""
    y = int4_matmul_plain(x, packed, scales).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


# --------------------------------------------------------------------------
# The CUDA kernels' wrappers
# --------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BM, _BK = 64, 64          # output rows per block, K rows per stage (csrc/quant_matmul.cuh)
_MAX_SPLITS = 8            # blocks per cluster, the portable limit (csrc/quant_matmul.cuh)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def k_splits(k: int, n: int, sms: int) -> int:
    """Split-K factor of a [., K] @ [K, N] product, a function of (K, N,
    SM count) only: about one block per SM for a single 64 x 32 row tile,
    in runs of at least two whole 64-deep K stages (so that one stage loads
    while the other computes), none empty, at most one cluster. Each output
    row's sum order is then fixed by K and N, whatever M is."""
    stages = max(1, -(-k // _BK))
    splits = max(1, min(stages // 2, _MAX_SPLITS, sms // -(-n // 32)))
    return -(-stages // -(-stages // splits))


def tile_n(m: int) -> int:
    """Output columns per block for M rows: 32 up to two row tiles, where
    the split-K runs fill the card; 64 and then 128 beyond, so that x is
    read from L2 fewer times. No element's arithmetic depends on it."""
    return 32 if m <= 2 * _BM else 64 if m <= 4 * _BM else 128


def _launch(
    kernel: str, symbol: str, x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
    bias: torch.Tensor | None, k: int, n: int, out_dtype: torch.dtype,
) -> torch.Tensor:
    """Launches one instance of the quantized matmul (every launcher takes x,
    weights, scales, bias, out, workspace, M, K, N, splits, tile width,
    stream) and counts the launch under `kernel`. No host sync; the split-K
    workspace, whose size follows M, comes from torch's allocator (under
    CUDA graph capture, from the graph's pool)."""
    if bias is not None:
        if bias.shape != (n,) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 [{n}], got {bias.dtype} {tuple(bias.shape)}")
        if bias.device != x.device or not bias.is_contiguous():
            raise ValueError("bias must be contiguous on x's device")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        splits = k_splits(k, n, _sm_count(x.device.index))
        workspace = torch.empty(-(-m // _BM) * _BM * -(-n // 128) * 128 * splits,
                                dtype=torch.float32, device=x.device)
        fn = kernels.function(kernel, symbol, _ARGTYPES)
        err = fn(
            x2.data_ptr(), w.data_ptr(), scales.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), workspace.data_ptr(),
            m, k, n, splits, tile_n(m), torch._C._cuda_getCurrentRawStream(x.device.index),
        )
        kernels.check(err, symbol)
        kernels.LAUNCHES[kernel] += 1
    return out.reshape(*lead, n)


def _check_int4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                block: int, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {x.device}")
    k = x.shape[-1]
    if packed.dim() != 2 or scales.dim() != 2:
        raise ValueError("packed and scales must be 2-D")
    n = packed.shape[1]
    if block != INT4_BLOCK:
        raise ValueError(f"the CUDA kernel takes block={INT4_BLOCK}, got {block}")
    if k % 2 or packed.shape[0] * 2 != k:
        raise ValueError(f"x has K={k}, packed holds {packed.shape[0] * 2} rows")
    if (k // 2) % block and k > block:
        raise ValueError(f"the CUDA kernel needs K/2 a multiple of {block} or K <= {block}, "
                         f"got K={k}")
    if tuple(scales.shape) != (-(-k // block), n):
        raise ValueError(f"scales {tuple(scales.shape)} do not fit K={k}, N={n}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("packed must be uint8 and scales float32")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if packed.device != x.device or scales.device != x.device:
        raise ValueError("x, packed and scales must be on one device")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed and scales must be contiguous")


def int4_matmul(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
    block: int = INT4_BLOCK,
) -> torch.Tensor:
    """x [..., M, K] @ dequant(packed [K//2, N], scales [ceil(K/32), N]) →
    f32 [..., M, N]. CUDA tensors go through the hand-written kernel, CPU
    tensors through int4_matmul_plain."""
    kernels.forward_only("int4_matmul", x, packed, scales)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, block)
    _check_int4(x, packed, scales, block, "int4_matmul")
    return _launch("int4_matmul", "tilawa_int4_matmul", x, packed, scales, None,
                   x.shape[-1], packed.shape[1], torch.float32)


def int4_dense(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
    bias: torch.Tensor | None = None, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Int4Dense: the int4 product cast to `dtype` (bfloat16 or float32),
    plus the bias cast to `dtype`, in one launch. CUDA tensors go through the
    hand-written kernel, CPU tensors through int4_dense_plain."""
    kernels.forward_only("int4_dense", x, packed, scales, bias)
    if x.device.type == "cpu":
        return int4_dense_plain(x, packed, scales, bias, dtype)
    _check_int4(x, packed, scales, INT4_BLOCK, "int4_dense")
    symbols = {torch.bfloat16: "tilawa_int4_dense", torch.float32: "tilawa_int4_matmul"}
    if dtype not in symbols:
        raise TypeError(f"the int4 kernel writes bfloat16 or float32, not {dtype}")
    return _launch("int4_matmul", symbols[dtype], x, packed, scales, bias,
                   x.shape[-1], packed.shape[1], dtype)


def _check_int8(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {x.device}")
    if q.dim() != 2 or scales.dim() != 1:
        raise ValueError("q must be 2-D and scales 1-D")
    if q.shape[0] != x.shape[-1] or scales.shape[0] != q.shape[1]:
        raise ValueError(
            f"x has K={x.shape[-1]}, q is {tuple(q.shape)}, scales {tuple(scales.shape)}"
        )
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("q must be int8 and scales float32")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if q.device != x.device or scales.device != x.device:
        raise ValueError("x, q and scales must be on one device")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q and scales must be contiguous")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [..., M, K] @ bf16(q [K, N] int8 * scales [N]) → f32 [..., M, N]
    (_int8_kernel's order: the scale is applied to W before the product).
    CUDA tensors go through the hand-written kernel, CPU tensors through
    int8_matmul_plain."""
    kernels.forward_only("int8_matmul", x, q, scales)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scales)
    _check_int8(x, q, scales, "int8_matmul")
    return _launch("int8_matmul", "tilawa_int8_matmul", x, q, scales, None, *q.shape,
                   torch.float32)


def int8_dense(
    x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """bf16(bf16(bf16(bf16(x) @ bf16(q)) * bf16(scales)) + bf16(bias)) →
    bf16 [..., M, N] (Int8Dense's order: the scale after the product, then
    the bias), in one launch. CUDA tensors go through the hand-written
    kernel, CPU tensors through int8_dense_plain."""
    kernels.forward_only("int8_dense", x, q, scales, bias)
    if x.device.type == "cpu":
        return int8_dense_plain(x, q, scales, bias)
    _check_int8(x, q, scales, "int8_dense")
    return _launch("int8_matmul", "tilawa_int8_dense", x, q, scales, bias, *q.shape,
                   torch.bfloat16)
