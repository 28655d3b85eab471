"""Bundle variables (nested numpy dicts, flax layout) → the torch state dict.

Three rewrites and nothing else:
  * the nn.scan depth axis is unstacked: params/blocks/block/ff1/lin1/packed
    (17, 256, 2048) becomes blocks.0.ff1.lin1.packed ... blocks.16...;
  * conv kernels go from flax HWIO to torch OIHW (2-D) or WIO to OIW (1-D):
    subsampling/conv_in/kernel (3,3,1,256) → (256,1,3,3), the depthwise
    blocks/block/conv/dw/kernel (9,1,512) → (512,1,9);
  * `batch_stats` (MaskedBatchNorm mean/var) land beside the params of the
    same module.
Packed int4 [K/2, N], scales [K/32, N] and Dense kernels [K, N] are kept as
they are. Every leaf maps to one key; load with strict=True so a leaf left
over, or a buffer left unset, is an error.
"""

from __future__ import annotations

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats")


def _leaves(tree: dict, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _to_torch(path: tuple[str, ...], arr: np.ndarray) -> torch.Tensor:
    if path[-1] == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif path[-1] == "kernel" and arr.ndim == 3:
        arr = arr.transpose(2, 1, 0)
    return torch.from_numpy(np.array(arr))


def params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} → state_dict for FastConformerCTC."""
    out: dict[str, torch.Tensor] = {}

    def put(path: tuple[str, ...], arr: np.ndarray) -> None:
        key = ".".join(path)
        if key in out:
            raise ValueError(f"two bundle leaves map to {key}")
        out[key] = _to_torch(path, arr)

    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    for collection in _COLLECTIONS:
        for path, arr in _leaves(variables.get(collection, {})):
            arr = np.asarray(arr)
            if path[0] == "blocks":
                if len(path) < 3 or path[1] != "block":
                    raise ValueError(f"unexpected scanned leaf {'/'.join(path)}")
                for i in range(arr.shape[0]):
                    put(("blocks", str(i)) + path[2:], arr[i])
            else:
                put(path, arr)
    return out


def load_into(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Copy a bundle's variables into `model`; every leaf and every buffer
    must match one to one."""
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model
