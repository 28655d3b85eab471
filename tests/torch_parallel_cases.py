"""The 8-rank CPU job of tests/test_torch_parallel.py (gloo, data 4 x model 2).

    python tests/torch_parallel_cases.py OUT_DIR

OUT_DIR holds `jax_state.pt` (the JAX-made variables of the dry run's
config as a port state dict) before the run. Every rank runs every case;
rank 0 writes every case's result to OUT_DIR/results.pt, with each rank's
digest of its replicated variables beside it. Imports torch and the port
only (no JAX): the test compares the results with the JAX package and the
single-process port itself.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tilawa_tpu_torch.models import fastconformer as tfc  # noqa: E402
from tilawa_tpu_torch.parallel import dryrun  # noqa: E402
from tilawa_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated  # noqa: E402
from tilawa_tpu_torch.parallel.sharding import (  # noqa: E402
    REPLICATED,
    batch_placements,
    data_batch_spec,
    opt_state_placements,
    shard_variables,
    variables_placements,
)
from tilawa_tpu_torch.ops import frontend, quant  # noqa: E402
from tilawa_tpu_torch.train import train as ttrain  # noqa: E402
from tilawa_tpu_torch.train.checkpoint import load_config  # noqa: E402
from tilawa_tpu_torch.train.data import synthetic_batches  # noqa: E402
from tilawa_tpu_torch.train.quantize import dequantized_config  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORLD, MODEL_PARALLEL = 8, 2
BATCH = 8            # 2 rows a data rank
STEPS = 2
CASES = [(0.1, False), (0.1, True), (0.0, False), (0.0, True)]   # (dropout, freeze_bn)


def config(dropout: float) -> tfc.FastConformerConfig:
    """The dry run's config (tilawa_tpu __graft_entry__.py)."""
    return tfc.FastConformerConfig.small(num_heads=4, d_model=64, dropout=dropout)


def batch():
    return next(synthetic_batches(batch_size=BATCH, n_samples=16000, vocab=1024, token_len=4))


def optimizer(model):
    """Warmup of 1 step, so that step 1 moves every parameter (step 0 has lr 0)."""
    return ttrain.make_optimizer(model.parameters(), lr=3e-4, warmup_steps=1, total_steps=10)


def _full(t: torch.Tensor) -> torch.Tensor:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def _names(model) -> dict:
    return {id(p): n for n, p in model.named_parameters()}


def _recording_grads(model, opt) -> list[dict]:
    """Wrap opt.step to keep each step's reduced gradient (gathered, before
    the clip and the update); returns the list it fills."""
    grads: list[dict] = []
    names = _names(model)
    update = opt.step

    def step():
        grads.append({names[id(p)]: _full(p.grad) for p in opt.params})
        update()

    opt.step = step
    return grads


def _replicated_digest(model) -> str:
    """A digest of this rank's replicated variables (parameters and
    BatchNorm stats) in name order: equal on every rank unless they drift."""
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        if all(p.is_replicate() for p in t.placements):
            h.update(name.encode() + t.to_local().numpy().tobytes())
    return h.hexdigest()


def _steps(mesh, dropout, freeze_bn) -> dict:
    """STEPS sharded steps from the seed-0 init on one batch."""
    model = shard_variables(ttrain.init_state(config(dropout), device="cpu"), mesh)
    opt = optimizer(model)
    grads = _recording_grads(model, opt)
    step_fn = ttrain.make_train_step(model.cfg.blank_id, freeze_bn=freeze_bn)
    state, b = ttrain.TrainState(model, opt), batch()
    losses = [float(step_fn(state, b, ttrain.step_generator(0, i, torch.device("cpu"))))
              for i in range(STEPS)]
    names = _names(model)
    want = opt_state_placements(opt)
    moments, placed = {}, []
    for p, pl in zip(opt.params, want):
        st = opt.adamw.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            moments[f"{names[id(p)]}.{k}"] = _full(st[k])
            placed.append(tuple(st[k].placements) == pl[k] == tuple(p.placements))
        placed.append(not hasattr(st["step"], "placements") and pl["step"] == REPLICATED)
    return {"losses": losses, "grads": grads,
            "state": {k: _full(v) for k, v in model.state_dict().items()},
            "moments": moments, "moments_placed": all(placed),
            "rank_parts": _rank_parts_alias(model),
            "digest": _replicated_digest(model)}


def _rank_parts_alias(model) -> bool:
    """Every DTensor variable's rank_part still lies on its local storage
    after the optimizer's updates, and holds no gradient of its own (the
    step handed it to the DTensor parameter)."""
    with torch.no_grad():
        return all(t.rank_part.data_ptr() == t.to_local().data_ptr()
                   and getattr(t.rank_part, "grad", None) is None
                   for t in [*model.parameters(), *model.buffers()] if hasattr(t, "to_local"))


def _jax_step(mesh, out_dir: Path, freeze_bn: bool) -> dict:
    """One sharded step from the JAX-made variables at dropout 0: the loss,
    the reduced gradient (gathered, before the clip and the update) and the
    new BatchNorm stats."""
    model = tfc.FastConformerCTC(config(0.0))
    model.load_state_dict(torch.load(out_dir / "jax_state.pt"), strict=True)
    shard_variables(model, mesh)
    opt = optimizer(model)
    grads = _recording_grads(model, opt)
    step_fn = ttrain.make_train_step(model.cfg.blank_id, freeze_bn=freeze_bn)
    loss = float(step_fn(ttrain.TrainState(model, opt), batch(),
                         ttrain.step_generator(0, 0, torch.device("cpu"))))
    return {"loss": loss, "grads": grads[0],
            "stats": {k: _full(v) for k, v in model.state_dict().items()
                      if k.endswith((".mean", ".var"))}}


def _inference(mesh, out_dir: Path) -> dict:
    """recognize_scores of the JAX-made variables over B = 4 (one row a
    data rank, the dry run's shape) and B = 8 (two: the attention products
    go row by row with out=, which must see local tensors only)."""
    model = tfc.FastConformerCTC(config(0.0))
    model.load_state_dict(torch.load(out_dir / "jax_state.pt"), strict=True)
    shard_variables(model, mesh)
    seen = []
    row_matmul = tfc._row_matmul

    def recorded(a, b):
        seen.append((a.shape[0], type(a).__name__, type(b).__name__))
        return row_matmul(a, b)

    tfc._row_matmul = recorded
    try:
        out = {f"scores_{n}": dryrun.recognize_scores(model, b[0][:n], b[1][:n],
                                                      *dryrun.rerank_candidates())
               for b in [batch()] for n in (4, 8)}
    finally:
        tfc._row_matmul = row_matmul
    out["row_matmul_calls"] = seen
    return out


def _placements(mesh) -> dict:
    """variables_placements of the dry run's model (and the placements its
    DTensors got) and of the champion's dequantized model (built on the
    meta device: only names and ranks matter)."""
    model = shard_variables(ttrain.init_state(config(0.1), device="cpu"), mesh)
    placed = {k: tuple(v.placements) for k, v in model.state_dict().items()}
    champion = dequantized_config(load_config(REPO / "exports" / "champion-int4"))
    with torch.device("meta"):
        big = tfc.FastConformerCTC(champion)

    def text(d):
        return {k: tuple(repr(p) for p in v) for k, v in d.items()}

    return {"dryrun": text(variables_placements(model, mesh)), "dryrun_placed": text(placed),
            "champion": text(variables_placements(big, mesh)),
            "inputs": text({"data_sharding": data_sharding(mesh), "replicated": replicated(mesh),
                            "data_batch_spec": data_batch_spec(),
                            "batch": batch_placements(mesh, data_batch_spec(), REPLICATED)})}


def _kernel_guards(mesh) -> dict:
    """Each kernel wrapper handed a DTensor: the exception it raised."""
    x = distribute_tensor(torch.randn(4, 64), mesh, REPLICATED)
    packed, scales = (torch.from_numpy(a) for a in quant.pack_int4(
        torch.randn(64, 16).numpy()))
    q, s8 = (torch.from_numpy(a) for a in quant.quantize_int8(torch.randn(64, 16).numpy()))
    pre = distribute_tensor(torch.randn(2, 4000), mesh, REPLICATED)
    audio = distribute_tensor(torch.randn(2, 4000), mesh, REPLICATED)
    calls = {
        "int4_matmul": lambda: quant.int4_matmul(x, packed, scales),
        "int4_dense": lambda: quant.int4_dense(x, packed, scales, None, torch.float32),
        "int8_matmul": lambda: quant.int8_matmul(x, q, s8),
        "int8_dense": lambda: quant.int8_dense(x, q, s8),
        "fused_log_mel": lambda: frontend.fused_log_mel(pre, frontend.mel_tables()),
        "log_mel_spectrogram": lambda: frontend.log_mel_spectrogram(
            audio, torch.tensor([4000, 4000]), frontend.mel_tables()),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = None
        except Exception as e:  # noqa: BLE001 - the test reads what was raised
            raised[name] = f"{type(e).__name__}: {e}"
    return raised


def _train_loop(mesh, out_dir: Path) -> dict:
    """train() with the mesh: two steps, a checkpoint written by rank 0,
    and the model's gathered state to hold the checkpoint to."""
    model, _state, history = ttrain.train(
        config(0.1), iter([batch()] * STEPS), STEPS, seed=0, log_every=1,
        checkpoint_dir=out_dir / "mesh_run", warmup_steps=1, device="cpu", mesh=mesh)
    return {"history": history, "state": {k: _full(v) for k, v in model.state_dict().items()}}


def run_cases(rank: int, world_size: int, dev: torch.device, out_dir: str) -> dict:
    out_dir = Path(out_dir)
    mesh = make_mesh(world_size, model_parallel=MODEL_PARALLEL, device="cpu")
    results = {"steps": {case: _steps(mesh, *case) for case in CASES},
               "jax": {fb: _jax_step(mesh, out_dir, fb) for fb in (False, True)},
               "inference": _inference(mesh, out_dir),
               "placements": _placements(mesh),
               "guards": _kernel_guards(mesh),
               "train": _train_loop(mesh, out_dir)}
    if rank == 0:
        return results
    # the other ranks report what must equal rank 0's
    return {"digests": {case: r["digest"] for case, r in results["steps"].items()},
            "losses": {case: r["losses"] for case, r in results["steps"].items()},
            "scores": results["inference"]["scores_8"]}


def main(out_dir: str) -> None:
    ranks = dryrun.spawn(run_cases, WORLD, "cpu", args=(out_dir,), rendezvous_dir=out_dir)
    results = ranks[0]
    results["others"] = ranks[1:]
    torch.save(results, Path(out_dir) / "results.pt")


if __name__ == "__main__":
    main(sys.argv[1])
