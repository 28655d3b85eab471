"""Parameter partitioning rules and the collectives of the sharded step.

Port of tilawa_tpu/parallel/sharding.py. Tensor-parallel layout for the
FastConformer (Megatron-style pairing, one sum over "model" per pair):

  * FFN: the first Dense kernel [d, f·d] column-sharded over "model", the
    second [f·d, d] row-sharded — its partial products summed after it.
  * Attention: q/k/v/pos kernels [d, d] column-sharded (heads split across
    "model"); the output projection row-sharded.
  * Everything else (convs, norms, biases, the u/v biases, the CTC head,
    BatchNorm's running stats) replicated.

Every variable becomes a DTensor with its placements on the (data, model)
mesh, mirroring the JAX package's NamedShardings; AdamW's moments take
their parameter's placements. The layers compute on plain tensors: each
DTensor variable carries `rank_part`, a plain tensor (a leaf Parameter for
a parameter) over its local storage, made once by shard_variables, which
the layers read in place of the DTensor. The optimizer updates a DTensor
in place, so its rank_part holds the new values with no copy;
reduce_gradients hands the gradients that the backward left on the
rank_parts to the DTensor parameters. Activations stay plain tensors
holding this rank's part (its batch rows; under a column-sharded Dense its
columns, in attention its heads), and the layers call the collectives of
MeshAxes at the points where the global program needs them:

  * a column-sharded Dense takes its input through model_copy (identity
    forward, gradient summed over "model": each rank holds the gradient of
    its own columns) and adds its bias' own columns; a row-sharded Dense
    sums its partial product over "model" (model_sum, identity backward)
    and adds the whole bias once;
  * attention adds the u/v rows of its own heads; the gradients of those
    biases and of the column biases are therefore partial over "model" and
    are summed there after the backward (reduce_gradients), so that the
    replicated copies stay equal;
  * MaskedBatchNorm sums its masked sums and count over "data" (data_sum,
    summed both ways: every data rank's loss uses the global statistics);
  * dropout and SpecAugment masks are drawn at the global shape with the
    same generator on every rank, then sliced to this rank's part.

The loss is this rank's share of the global batch mean (its rows' sum over
the global batch size), so the gradients are summed over "data".
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from tilawa_tpu_torch.models.fastconformer import (
    Dense,
    FastConformerCTC,
    MaskedBatchNorm,
    RelPosSelfAttention,
)
from tilawa_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, _check

REPLICATED = (Replicate(), Replicate())
COL = (Replicate(), Shard(1))   # P(None, "model") of a [K, N] kernel: output columns split
ROW = (Replicate(), Shard(0))   # P("model", None): input rows split


def param_spec(path: str | tuple[str, ...], ndim: int) -> tuple:
    """Placements on the (data, model) mesh for one parameter, keyed by its
    name (`blocks.3.ff1.lin1.kernel`, or the flax path as a tuple), with
    the JAX package's rules. The port's Dense keeps flax's [K, N] kernel,
    so column-sharded is Shard(1) and row-sharded Shard(0) on "model";
    "data" always replicates. The port has one module per block, not
    scan-stacked [L, K, N] leaves, so there is no leading layer axis to
    skip: a JAX stacked leaf maps to the port's with that axis dropped."""
    names = path.split(".") if isinstance(path, str) else [str(p) for p in path]
    joined = "/".join(names)
    if ndim < 2:
        return REPLICATED
    # FFN pair (explicitly named lin1/lin2 in FeedForward)
    if "lin1" in joined and ("ff1" in joined or "ff2" in joined):
        return COL
    if "lin2" in joined and ("ff1" in joined or "ff2" in joined):
        return ROW
    # Attention projections
    if "attn" in joined:
        if any(f"/{k}/" in joined + "/" for k in ("q", "k", "v", "pos")):
            return COL
        if "/out/" in joined + "/":
            return ROW
    return REPLICATED


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over "model"."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _SumOverModel(torch.autograd.Function):
    """Megatron's g: partial products summed over "model", identity
    backward (every model rank holds the same downstream gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverData(torch.autograd.Function):
    """A sum over "data" used by every data rank's share of the loss: the
    gradient is summed over "data" too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class MeshAxes:
    """The mesh's two axes as process groups, with this rank's index on
    each, and the collectives the sharded layers call. A collective over
    an axis of one rank is the identity and is skipped, as XLA skips it:
    on a one-card mesh the step makes no NCCL call."""

    def __init__(self, mesh: DeviceMesh):
        _check(mesh)
        self.mesh = mesh
        self.data_group = mesh.get_group(DATA_AXIS)
        self.model_group = mesh.get_group(MODEL_AXIS)
        self.data_rank = mesh.get_local_rank(DATA_AXIS)
        self.model_rank = mesh.get_local_rank(MODEL_AXIS)
        self.data_size = mesh.size(0)
        self.model_size = mesh.size(1)

    def rows(self, global_rows: int) -> slice:
        """This rank's rows of a global batch (split evenly over "data")."""
        if global_rows % self.data_size:
            raise ValueError(f"a batch of {global_rows} rows does not split over "
                             f"{self.data_size} data ranks")
        n = global_rows // self.data_size
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def model_slice(self, n: int) -> slice:
        """This rank's part of n columns (or heads) split over "model"."""
        if n % self.model_size:
            raise ValueError(f"{n} columns do not split over {self.model_size} model ranks")
        k = n // self.model_size
        return slice(self.model_rank * k, (self.model_rank + 1) * k)

    def model_copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.model_size == 1 else _CopyToModel.apply(x, self.model_group)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.model_size == 1 else _SumOverModel.apply(x, self.model_group)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.data_size == 1 else _SumOverData.apply(x, self.data_group)

    def data_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's x (equal shapes) concatenated in rank order
        along dim 0; no gradient."""
        if self.data_size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.data_size)]
        dist.all_gather(parts, x.contiguous(), group=self.data_group)
        return torch.cat(parts)


def variables_placements(model: FastConformerCTC, mesh: DeviceMesh) -> dict[str, tuple]:
    """Placements of every variable of `model` by state-dict key:
    parameters per param_spec, BatchNorm's running stats replicated."""
    _check(mesh)
    out = {name: param_spec(name, p.dim()) for name, p in model.named_parameters()}
    for name in model.state_dict():
        out.setdefault(name, REPLICATED)
    return out


def shard_variables(model: FastConformerCTC, mesh: DeviceMesh) -> FastConformerCTC:
    """Place `model`'s variables on the mesh, in place: every parameter
    and BatchNorm buffer becomes a DTensor with its placements
    (distribute_tensor, rank 0's values) and its rank_part, and the layers
    that act on the mesh get its MeshAxes. A float model only: the
    quantized kernels take plain tensors."""
    if model.cfg.quant is not None:
        raise ValueError(f"the multi-device step shards float models, not {model.cfg.quant}")
    placements = variables_placements(model, mesh)
    axes = MeshAxes(mesh)
    for prefix, module in model.named_modules():
        def key(name):
            return f"{prefix}.{name}" if prefix else name

        for name, p in list(module.named_parameters(recurse=False)):
            sharded = nn.Parameter(distribute_tensor(p.detach(), mesh, placements[key(name)]),
                                   requires_grad=p.requires_grad)
            sharded.rank_part = nn.Parameter(sharded.detach().to_local(),
                                             requires_grad=p.requires_grad)
            module.register_parameter(name, sharded)
        for name, b in list(module.named_buffers(recurse=False)):
            if key(name) in placements:   # persistent: BatchNorm's stats
                sharded = distribute_tensor(b, mesh, placements[key(name)])
                sharded.rank_part = sharded.to_local()
                module.register_buffer(name, sharded)
        if isinstance(module, Dense):
            module.split = {COL: "col", ROW: "row"}.get(placements[key("kernel")])
        if isinstance(module, (Dense, RelPosSelfAttention, MaskedBatchNorm, FastConformerCTC)):
            module.axes = axes
    return model


def _model_partial(model: FastConformerCTC) -> list[nn.Parameter]:
    """The replicated parameters each model rank uses only in part: the
    biases of column-sharded Dense layers and attention's u/v biases."""
    out = []
    for module in model.modules():
        if isinstance(module, Dense) and module.split == "col" and module.bias is not None:
            out.append(module.bias)
        elif isinstance(module, RelPosSelfAttention):
            out += [module.bias_u, module.bias_v]
    return out


def _sum_into(tensors: list[torch.Tensor], group) -> None:
    """All-reduce (sum) the tensors in place as one flat buffer."""
    if not tensors or dist.get_world_size(group) == 1:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    for t, s in zip(tensors, torch._utils._unflatten_dense_tensors(flat, tensors)):
        t.copy_(s)


@torch.no_grad()
def reduce_gradients(model: FastConformerCTC) -> None:
    """After the backward of this rank's share of the loss, which leaves
    the gradients on the rank_parts: every gradient summed over "data", the
    model-partial ones over "model" as well, then each handed to its
    DTensor parameter with the parameter's placements (no copy)."""
    axes = model.axes
    params = [p for p in model.parameters() if p.rank_part.grad is not None]
    _sum_into([p.rank_part.grad for p in params], axes.data_group)
    _sum_into([p.rank_part.grad for p in _model_partial(model) if p.rank_part.grad is not None],
              axes.model_group)
    for p in params:
        p.grad = DTensor.from_local(p.rank_part.grad, axes.mesh, p.placements, run_check=False,
                                    shape=p.shape, stride=p.stride())
        p.rank_part.grad = None


def opt_state_placements(optimizer) -> list[dict[str, tuple]]:
    """AdamW's state placements, one dict per parameter of the port's
    Optimizer in its order: the moments take their parameter's placements,
    the step count is replicated (a scalar every rank holds)."""
    return [{"step": REPLICATED, "exp_avg": tuple(p.placements),
             "exp_avg_sq": tuple(p.placements)} for p in optimizer.params]


def batch_placements(mesh: DeviceMesh, *specs) -> tuple:
    _check(mesh)
    return tuple(tuple(s) for s in specs)


def data_batch_spec() -> tuple:
    return (Shard(0), Replicate())
