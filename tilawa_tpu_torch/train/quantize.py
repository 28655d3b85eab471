"""Post-training quantization of a bundle's variables: fp Dense kernels →
packed int4 (or the mixed int4/int8 recipe), and back.

Port of tilawa_tpu/train/quantize.py. Numpy over the nested-dict tree the
port's bundle reader returns: every eligible Dense `kernel` becomes
`packed`/`scales` (int4, ops/quant.pack_int4) or `q`/`scales` (int8,
ops/quant.quantize_int8), with the bias kept as it is, so the result loads
with models/convert.load_into into a model built with
quantized_config(config). dequantize_params is the inverse (f32 kernels,
the warm start of continuation training); int4 → f32 → int4 gives back the
same bytes. Leaves stay numpy arrays, and each map keeps the order of the
tree given, with a quantized layer's leaves in the order packed (or q),
scales, bias and a dequantized one's as kernel, bias: the order the JAX
package builds, on which the bytes of a written bundle depend.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tilawa_tpu_torch.models.convert import packed_size_bytes  # noqa: F401 (re-export)
from tilawa_tpu_torch.models.fastconformer import MIXED_INT4_NAMES, FastConformerConfig
from tilawa_tpu_torch.ops.quant import (
    INT4_BLOCK,
    dequantize_int8,
    pack_int4,
    quantize_int8,
    unpack_int4,
)

# Module names whose `kernel` is a matmul weight (rank-2, or rank-3 when
# scan-stacked over layers). Convs/LayerNorms are not in this set.
ELIGIBLE_DENSE = {
    "lin1", "lin2",          # feed-forward pair
    "q", "k", "v", "pos", "out",  # attention projections
    "pw1", "pw2",            # conv-module pointwise matmuls
    "proj",                  # subsampling output projection
    "ctc_head",
}


def _pack_kernel(kern: np.ndarray, block: int) -> tuple[np.ndarray, np.ndarray]:
    if kern.ndim == 2:
        return pack_int4(kern, block)
    # scan-stacked [L, K, N]: pack each layer slice
    packed, scales = zip(*(pack_int4(kern[i], block) for i in range(kern.shape[0])))
    return np.stack(packed), np.stack(scales)


def quantize_params(
    params: dict, block: int = INT4_BLOCK, mode: str = "int4"
) -> dict:
    """mode "int4" packs every eligible Dense; "mixed" packs the
    feed-forward pair (MIXED_INT4_NAMES) to int4 and the rest to int8."""
    out = {}
    for name, sub in params.items():
        if name in ELIGIBLE_DENSE and isinstance(sub, dict) and "kernel" in sub:
            kern = np.asarray(sub["kernel"])
            leaf_mode = mode
            if mode == "mixed":
                leaf_mode = "int4" if name in MIXED_INT4_NAMES else "int8"
            if leaf_mode == "int8":
                q, scales = quantize_int8(kern)
                entry = {"q": q, "scales": scales}
            else:
                packed, scales = _pack_kernel(kern, block)
                entry = {"packed": packed, "scales": scales}
            if "bias" in sub:
                entry["bias"] = sub["bias"]
            out[name] = entry
        elif isinstance(sub, dict):
            out[name] = quantize_params(sub, block, mode)
        else:
            out[name] = sub
    return out


def quantize_variables(
    variables: dict, block: int = INT4_BLOCK, mode: str = "int4"
) -> dict:
    new = dict(variables)
    new["params"] = quantize_params(dict(variables["params"]), block, mode)
    return new


def quantized_config(
    config: FastConformerConfig, mode: str = "int4", **overrides
) -> FastConformerConfig:
    return dataclasses.replace(config, quant=mode, **overrides)


def _unpack_kernel(packed: np.ndarray, scales: np.ndarray, block: int) -> np.ndarray:
    if packed.ndim == 2:
        return unpack_int4(packed, scales, block)
    # scan-stacked [L, K//2, N]
    return np.stack([unpack_int4(packed[i], scales[i], block) for i in range(packed.shape[0])])


def dequantize_params(params: dict, block: int = INT4_BLOCK) -> dict:
    """Inverse of quantize_params: packed int4 and int8 leaves back to f32
    kernels (lossy against the original fp weights; the warm start of
    continuation training when only a quantized export survives)."""
    out = {}
    for name, sub in params.items():
        if isinstance(sub, dict) and "scales" in sub and ("packed" in sub or "q" in sub):
            if "packed" in sub:
                kern = _unpack_kernel(np.asarray(sub["packed"]), np.asarray(sub["scales"]), block)
            else:
                kern = dequantize_int8(np.asarray(sub["q"]), np.asarray(sub["scales"]))
            entry = {"kernel": kern.astype(np.float32)}
            if "bias" in sub:
                entry["bias"] = sub["bias"]
            out[name] = entry
        elif isinstance(sub, dict):
            out[name] = dequantize_params(sub, block)
        else:
            out[name] = sub
    return out


def dequantize_variables(variables: dict, block: int = INT4_BLOCK) -> dict:
    new = dict(variables)
    new["params"] = dequantize_params(dict(variables["params"]), block)
    return new


def dequantized_config(config: FastConformerConfig, **overrides) -> FastConformerConfig:
    return dataclasses.replace(config, quant=None, **overrides)
