"""Device mesh construction for SPMD execution.

Port of tilawa_tpu/parallel/mesh.py. The JAX package runs one program over
a ("data", "model") mesh of devices; here every device is a process (a
rank) of a torch.distributed process group, and the mesh is a DeviceMesh
over those ranks with the same two named axes: the batch axis (corpus
samples, TTA variants, rerank candidates) shards over "data", the model's
wide matmuls optionally over "model" (tensor parallelism). On the card
the group is NCCL, one rank per card; gloo on the CPU only where the
caller asks for device "cpu". NCCL refuses two ranks on one card, so a
one-card machine runs the mesh at world size 1.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from tilawa_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(device: str | torch.device, rank: int, world_size: int,
                     init_method: str) -> torch.device:
    """Join the process group as `rank` of `world_size` and return this
    rank's device: NCCL on cuda (card `rank` modulo the cards present),
    gloo where the caller asks for "cpu". Nothing on the machine tells a
    program of a cluster, so the rendezvous is given: `init_method` is
    "tcp://localhost:<port>" or "file://<path>" (one file per job). Raises
    where CUDA or NCCL is missing for a cuda mesh."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL; a cuda mesh cannot be built")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh of shape (n // model_parallel,
    model_parallel) over the process group's ranks (n, by default the
    world size, must equal it: one rank a device). Raises ValueError where
    n is not divisible by model_parallel, and where CUDA is absent for a
    cuda mesh."""
    dev = resolve_device(device)
    if n_devices is not None and n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of {n_devices} ranks, "
                         f"not {n}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: DeviceMesh) -> list:
    """Batch-axis placements for inputs: rows split over "data"."""
    _check(mesh)
    return [Shard(0), Replicate()]


def replicated(mesh: DeviceMesh) -> list:
    _check(mesh)
    return [Replicate(), Replicate()]


def _check(mesh: DeviceMesh) -> None:
    if tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"want a ({DATA_AXIS!r}, {MODEL_AXIS!r}) mesh, got "
                         f"{mesh.mesh_dim_names}")
