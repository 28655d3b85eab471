"""Entry points of the port's dry runs: the counterpart of __graft_entry__.py.

entry()               — the flagship FastConformer's forward and its
                        arguments (one device, zero weights).
dryrun_multichip(n)   — an n-device ("data", "model") mesh, one process a
                        device: ONE full training step (dp batch sharding
                        + tp Megatron-style sharding of the FFN/attention
                        matmuls) on tiny shapes, then one dp/tp-sharded
                        inference + CTC rerank dispatch.

    python -m tilawa_tpu_torch.parallel.dryrun                  # every card, NCCL
    python -m tilawa_tpu_torch.parallel.dryrun --device cpu --devices 8
                                                 # 8 gloo processes, data 4 x model 2

NCCL refuses two ranks on one card, so a one-card machine runs the mesh at
world size 1 (data 1 x model 1); the 8-rank layout runs on the CPU.
"""

from __future__ import annotations

import multiprocessing
import pickle
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from tilawa_tpu_torch.device import resolve_device, upload
from tilawa_tpu_torch.models.fastconformer import FastConformerConfig, FastConformerCTC
from tilawa_tpu_torch.ops.ctc import ctc_forward_scores_batch
from tilawa_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    data_sharding,
    init_distributed,
    make_mesh,
)
from tilawa_tpu_torch.parallel.sharding import shard_variables
from tilawa_tpu_torch.train.data import synthetic_batches
from tilawa_tpu_torch.train.train import (
    TrainState,
    init_state,
    make_optimizer,
    make_train_step,
    step_generator,
)

RANK_TIMEOUT_S = 600.0
DRYRUN_RTOL = 1e-5


def entry(device: str | torch.device = "cuda"):
    """The large config's forward (deterministic, running BatchNorm stats)
    with its arguments: every variable zero, one 4 s clip of silence."""
    dev = resolve_device(device)
    model = FastConformerCTC(FastConformerConfig.large()).to(dev)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    audio = torch.zeros((1, 64000), dtype=torch.float32, device=dev)
    lengths = torch.tensor([64000], dtype=torch.int32, device=dev)

    def forward(model, audio, lengths):
        return model(audio, lengths, deterministic=True, use_running_average=True)

    return forward, (model, audio, lengths)


def _rank_main(fn, rank: int, world_size: int, device: str, init_method: str, args,
               results) -> None:
    """One rank: join the group, run fn(rank, world_size, device, *args),
    leave the group, and hand the value (or the traceback) to the parent.
    The value goes pickled: a queue would share a tensor's memory with the
    parent, which this process takes with it when it exits."""
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        dev = init_distributed(device, rank, world_size, init_method)
        try:
            value = fn(rank, world_size, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(value)))
    except BaseException:  # report any failure to the parent, then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, device: str = "cuda", args: tuple = (),
          rendezvous_dir: str | None = None) -> list:
    """Run fn(rank, world_size, device, *args) in world_size new processes
    (spawned) that form one process group (NCCL on cuda, gloo on cpu;
    rendezvous through a file in a temporary directory under
    `rendezvous_dir`) and return their values in rank order. fn and its
    values must pickle. Raises on the first rank that fails or dies, or at
    RANK_TIMEOUT_S; every process is stopped before it returns."""
    resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    values: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="tilawa_mesh_", dir=rendezvous_dir) as tmp:
        init_method = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world_size, str(device), init_method, args, results))
                 for rank in range(world_size)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.start()
            while len(values) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in values and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"ranks exited without a result: {dead}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} ranks not done in {RANK_TIMEOUT_S} s") \
                            from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                values[rank] = pickle.loads(value)
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [values[r] for r in range(world_size)]


@torch.no_grad()
def recognize_scores(model: FastConformerCTC, audio: np.ndarray, lengths: np.ndarray,
                     cand_tokens: np.ndarray, cand_lens: np.ndarray) -> torch.Tensor:
    """One forward (deterministic, running BatchNorm stats) of a host batch
    and the CTC scores of every candidate against every row: [B, C]. A
    sharded model forwards this rank's rows only and the [B_local, C]
    scores are gathered over "data" (every rank returns all B rows)."""
    dev = model.mel_window.device
    axes = model.axes
    rows = slice(None) if axes is None else axes.rows(len(lengths))
    lp, enc_lens = model(upload(np.asarray(audio[rows], np.float32), dev),
                         upload(np.asarray(lengths[rows], np.int32), dev),
                         deterministic=True, use_running_average=True)
    scores = ctc_forward_scores_batch(lp, enc_lens, upload(np.asarray(cand_tokens), dev),
                                      upload(np.asarray(cand_lens), dev), model.cfg.blank_id)
    if axes is None:
        return scores
    return DTensor.from_local(scores, axes.mesh, data_sharding(axes.mesh)).full_tensor()


def rerank_candidates() -> tuple[np.ndarray, np.ndarray]:
    """The dry run's 6 candidates: tokens 1..4 each (tilawa_tpu
    __graft_entry__.py)."""
    return np.tile(np.arange(1, 5, dtype=np.int32)[None, :], (6, 1)), np.full(6, 4, np.int32)


def _mesh_shape(world_size: int) -> tuple[int, int]:
    """(data, model) of the dry run's mesh: model 2 where the world is even."""
    model_parallel = 2 if world_size % 2 == 0 and world_size >= 2 else 1
    return world_size // model_parallel, model_parallel


def _step_and_scores(dev: torch.device, batch_size: int, mesh=None) -> tuple[float, np.ndarray]:
    """The dry run's work on one device, or on this rank of `mesh`: one
    training step of the tiny config from the seed-0 init (dropout 0.1,
    live BatchNorm) and the CTC scores of the candidates after it; the
    loss and the [B, 6] scores."""
    # Tiny-but-real topology: 2 conformer blocks, shardable head/ff dims.
    config = FastConformerConfig.small(num_heads=4, d_model=64)
    model = init_state(config, device=dev)
    if mesh is not None:
        shard_variables(model, mesh)
    optimizer = make_optimizer(model.parameters(), total_steps=10)
    step_fn = make_train_step(config.blank_id)
    # 16000 samples → 98 mel frames → 13 encoder frames; 4 tokens → 9 CTC
    # states ≤ 13, so the loss is a real alignment, not the infeasible clamp.
    batch = next(synthetic_batches(batch_size=batch_size, n_samples=16000,
                                   vocab=config.vocab_size, token_len=4))
    loss = float(step_fn(TrainState(model, optimizer), batch, step_generator(0, 0, dev)))
    # Sharded inference: corpus rows dp-sharded, the model tp-sharded; one
    # forward and the CTC rerank of the candidates on each data rank's rows.
    scores = recognize_scores(model, batch[0], batch[1], *rerank_candidates())
    return loss, scores.cpu().numpy()


def _dryrun_rank(rank: int, world_size: int, dev: torch.device) -> dict:
    data, model_parallel = _mesh_shape(world_size)
    mesh = make_mesh(world_size, model_parallel=model_parallel, device=dev.type)
    batch_size = max(world_size // model_parallel, mesh.size(0))
    loss, scores = _step_and_scores(dev, batch_size, mesh)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if loss >= 1e4:
        raise RuntimeError(f"loss {loss} hit the infeasible-alignment clamp")
    if scores.shape != (batch_size, 6):
        raise RuntimeError(f"scores {scores.shape}, want {(batch_size, 6)}")
    if not np.all(np.isfinite(scores) | np.isinf(scores)):
        raise RuntimeError("a score is NaN")
    return {"loss": loss, "mesh": {DATA_AXIS: mesh.size(0), MODEL_AXIS: mesh.size(1)},
            "scores": scores}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """The dry run over n_devices ranks (one process each); prints and
    returns the JAX package's line with this run's loss. Every rank must
    report the same loss and scores, and they must be one device's: the
    same step and dispatch run unsharded in this process after the ranks
    (loss and finite scores within DRYRUN_RTOL, the same infinities; f32,
    sums in other orders)."""
    ranks = spawn(_dryrun_rank, n_devices, device)
    first = ranks[0]
    for r, other in enumerate(ranks[1:], 1):
        if other["loss"] != first["loss"] or not np.array_equal(other["scores"],
                                                                first["scores"]):
            raise RuntimeError(f"rank {r} disagrees with rank 0: loss {other['loss']} vs "
                               f"{first['loss']}")
    loss, scores = _step_and_scores(resolve_device(device), len(first["scores"]))
    finite = np.isfinite(scores)
    d_loss = abs(first["loss"] - loss)
    d_score = float(np.abs(first["scores"][finite] - scores[finite]).max()) if finite.any() else 0.0
    print(f"dryrun_multichip: one device's step and dispatch: loss {loss:.6f} (|Δ| {d_loss:.3g}), "
          f"max|Δ score| {d_score:.3g}", flush=True)
    if not (d_loss <= DRYRUN_RTOL * abs(loss) and np.array_equal(finite, np.isfinite(
            first["scores"])) and d_score <= DRYRUN_RTOL * np.abs(scores[finite]).max()):
        raise RuntimeError("the sharded step or dispatch differs from one device's")
    line = (f"dryrun_multichip ok: {n_devices} devices, mesh {first['mesh']}, "
            f"1 train step (loss {first['loss']:.4f}) + 1 dp/tp-sharded inference+rerank "
            f"dispatch (scores {first['scores'].shape})")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="multi-device dry run of the port")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default: NCCL, one rank a card) or cpu (gloo)")
    parser.add_argument("--devices", type=int, default=None,
                        help="ranks: every card on cuda, 8 on cpu by default")
    args = parser.parse_args(argv)
    if args.devices is not None:
        n = args.devices
    elif args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            print("dryrun: no CUDA device (pass --device cpu for gloo ranks)", file=sys.stderr)
            return 1
    else:
        n = 8
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
