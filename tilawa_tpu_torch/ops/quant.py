"""Int4 weight packing and the int4 dequantizing matmul.

Port of tilawa_tpu/ops/quant.py. Layout (int4): weights [K, N] are
split-half packed along K — byte row k2 holds k = k2 in the low nibble and
k = k2 + K/2 in the high nibble. Scales are symmetric, per (32-row K block,
output column).

`int4_matmul` launches the hand-written CUDA kernel (csrc/int4_matmul.cu)
for a CUDA tensor and uses `int4_matmul_plain` for a CPU tensor; the plain
version is also what the kernel is held against on the card.
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


# --------------------------------------------------------------------------
# Plain PyTorch version (CPU tensors; the kernel's oracle on the card)
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


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_TILE_M, _TILE_N, _TILE_K = 32, 64, 32   # the kernel's block tile (csrc/int4_matmul.cu)
_MAX_SPLITS = 16


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _k_splits(m: int, k: int, n: int, sms: int) -> int:
    """Split-K factor that gives the [M, N] tile grid about two blocks per
    SM (batch-1 shapes have 16..64 output tiles for 132 SMs)."""
    tiles = -(-m // _TILE_M) * -(-n // _TILE_N)
    return max(1, min(-(-k // _TILE_K), _MAX_SPLITS, -(-2 * sms // tiles)))


def int4_matmul(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
    block: int = INT4_BLOCK,
) -> torch.Tensor:
    """x [..., M, K] @ dequant(packed [K//2, N], scales [ceil(K/32), N]) →
    f32 [..., M, N]. CUDA tensors go through the hand-written kernel, CPU
    tensors through int4_matmul_plain."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, block)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu tensors, got {x.device}")
    k = x.shape[-1]
    if packed.dim() != 2 or scales.dim() != 2:
        raise ValueError("packed and scales must be 2-D")
    n = packed.shape[1]
    if block != INT4_BLOCK:
        raise ValueError(f"the CUDA kernel takes block={INT4_BLOCK}, got {block}")
    if k % 2 or packed.shape[0] * 2 != k:
        raise ValueError(f"x has K={k}, packed holds {packed.shape[0] * 2} rows")
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

    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        splits = _k_splits(m, k, n, _sm_count(x.device.index))
        workspace = (
            torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else out
        )
        fn = kernels.function("int4_matmul", "tilawa_int4_matmul", _ARGTYPES)
        err = fn(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), m, k, n, splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        kernels.check(err, "int4_matmul")
        kernels.LAUNCHES["int4_matmul"] += 1
    return out.reshape(*lead, n)
