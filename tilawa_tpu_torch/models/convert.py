"""Bundle variables (nested numpy dicts, flax layout) ↔ the torch state dict.

params_from_jax makes three rewrites and nothing else:
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

variables_from_torch is the reverse: `blocks.i.*` restacked onto the scan
axis, OIHW → HWIO and OIW → WIO, BatchNorm `mean`/`var` back into
`batch_stats`. Its maps are in sorted key order at every level, the order
of a tree that went through JAX's tree utilities (a JAX training state),
so a checkpoint the port writes quantizes (train/quantize.py) to the same
bytes as one written by the JAX package.
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


def packed_size_bytes(variables: dict) -> int:
    """Bytes of every leaf of a bundle's variables (the model size the
    runner and the server report; tilawa_tpu train/quantize.py)."""
    return sum(
        arr.size * arr.dtype.itemsize
        for _path, arr in _leaves(variables)
        if hasattr(arr, "dtype")
    )


_BATCH_STATS = ("mean", "var")


def _to_flax(path: tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel" and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if path[-1] == "kernel" and arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    return arr


def _sorted(tree: dict) -> dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def variables_from_torch(state: dict[str, torch.Tensor] | torch.nn.Module) -> dict:
    """A FastConformerCTC (or its state_dict) → {"batch_stats": ...,
    "params": ...} of numpy leaves in the bundle layout, maps sorted."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    tree: dict = {}
    stacked: dict[tuple[str, ...], dict[int, np.ndarray]] = {}
    for key, tensor in state.items():
        path = tuple(key.split("."))
        collection = "batch_stats" if path[-1] in _BATCH_STATS else "params"
        arr = _to_flax(path, tensor.detach().cpu().numpy())
        if path[0] == "blocks":
            stacked.setdefault((collection, "blocks", "block") + path[2:], {})[int(path[1])] = arr
        else:
            _put(tree, (collection,) + path, arr)
    for path, layers in stacked.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"blocks {sorted(layers)} of {'/'.join(path)} are not 0..L-1")
        _put(tree, path, np.stack([layers[i] for i in range(len(layers))]))
    return _sorted(tree)


def _put(tree: dict, path: tuple[str, ...], arr: np.ndarray) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if path[-1] in tree:
        raise ValueError(f"two state-dict keys map to {'/'.join(path)}")
    tree[path[-1]] = arr


def load_into(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Copy a bundle's variables into `model`; every leaf and every buffer
    must match one to one."""
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model
