"""Device selection and host-to-device uploads for the port."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The card unless the caller names another device. Asking for CUDA on
    a machine without it raises: the port does not carry on on the CPU
    unless told to (device="cpu")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch ops on the CPU"
        )
    return dev


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`, queued without a host sync.

    A copy from pageable memory makes PyTorch synchronize the stream after
    it, so the host would wait for every kernel queued before. The array is
    staged in pinned memory from PyTorch's caching host allocator and copied
    with non_blocking=True. The staging tensor may be dropped on return: the
    allocator records an event on the current stream for the copy and hands
    the pinned block out again only after that event has completed. On the
    CPU the array's own memory is used."""
    tensor = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cpu":
        return tensor
    return tensor.pin_memory().to(device, non_blocking=True)
