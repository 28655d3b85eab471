"""CTC training loop: AdamW with warmup-cosine, f32 master weights.

Port of tilawa_tpu/train/train.py. The model holds the state: its f32
Parameters are the params, its BatchNorm buffers the batch_stats, the
optimizer's state the opt_state; the compute dtype (bfloat16 for the
champion) is cast inside each layer, as flax does.

With a mesh (parallel/mesh.py make_mesh; one process a device) the step is
the JAX package's SPMD step over ("data", "model"): the variables are
DTensors placed by parallel/sharding.py, every rank reads the same global
batch and runs its own rows, with the FFN and attention matmuls split over
"model". It computes the function the single-device step computes: the
loss is the global batch mean, the gradients are summed over "data"
(reduce_gradients), the global-norm clip takes the norm of the full
gradient (each replicated leaf counted once) and AdamW (foreach, never
fused) updates each rank's part.

The optimizer is optax's chain written out (make_optimizer):
clip_by_global_norm(1.0) — g scaled by max_norm/‖g‖ only where ‖g‖ ≥
max_norm, with no epsilon (torch's clip_grad_norm_ adds 1e-6) — then
torch.optim.AdamW (β 0.9/0.999, eps 1e-8, weight decay 1e-4 on every
parameter: optax's mask is None, so norms are decayed too) at optax's
warmup_cosine_decay_schedule(0, lr, warmup, total) taken at the update
count before the update, so step 0 has lr 0 and changes no parameter.

ctc_loss_fn is optax.ctc_loss's mean over the batch: ctc_losses is one call
of ops/ctc.py ctc_loss, an autograd Function whose forward and backward
are each one launch of the hand-written CUDA kernels (csrc/ctc_loss.cu) on
the card, and the plain recursion on the CPU. It is optax's function, not
PyTorch's: log(0) is log_epsilon = -1e5, so an infeasible row (fewer frames
than labels plus repeated neighbours; random_window_crop followed by the
0.9x speed perturbation of train/data.py does produce them, and phoneme
batches often) has a large finite loss, never inf; the input is normalized
again (log_softmax), and the gradient is autodiff's of that recursion, the
softmax Jacobian included. Its sums run in a fixed order with no atomics,
so two runs give the same loss and gradient bit for bit. The lengths and tokens come from
the host's batch (encoder_lengths from the sample counts) and reach the
card with device.upload; the kernels read them there, so a step makes no
host sync; train() reads the loss only at log_every.

Randomness: one torch.Generator per step, seeded from (seed + 1, step)
(step_generator), so any step can be repeated; it draws SpecAugment and
dropout (models/fastconformer.py).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from tilawa_tpu_torch.device import resolve_device, upload
from tilawa_tpu_torch.models.fastconformer import (
    FastConformerConfig,
    FastConformerCTC,
    subsampled_length,
)
from tilawa_tpu_torch.ops.ctc import ctc_loss
from tilawa_tpu_torch.ops.frontend import HOP_LENGTH, WIN_LENGTH


@dataclasses.dataclass
class TrainState:
    model: FastConformerCTC
    optimizer: "Optimizer"
    step: int = 0


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine to end_value at decay_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every g scaled by max_norm / ‖g‖
    where the global norm ‖g‖ ≥ max_norm, unchanged (times 1.0) below it;
    no epsilon, no host sync. Returns the norm. DTensor gradients (a
    sharded model) give the full gradient's norm and scale their local
    parts."""
    norm = torch.nn.utils.get_total_norm(grads)
    if hasattr(norm, "full_tensor"):
        norm = norm.full_tensor()
        grads = [g.to_local() for g in grads]
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, 0.9,
    0.999, 1e-8, weight_decay)) over a list of parameters."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, max_norm: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.max_norm = max_norm
        self.count = 0
        # PyTorch's default picks foreach on CUDA (DTensors included) and
        # never the fused kernel
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        clip_by_global_norm(grads, self.max_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1


def make_optimizer(
    params, lr: float = 3e-4, warmup_steps: int = 100, total_steps: int = 10_000,
    weight_decay: float = 1e-4,
) -> Optimizer:
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))
    return Optimizer(params, sched, weight_decay=weight_decay)


def encoder_lengths(audio_lens) -> np.ndarray:
    """Encoder frame counts of sample counts, on the host (the frontend's
    frames_for_length, then subsampled_length)."""
    frames = np.maximum(1 + (np.asarray(audio_lens, np.int64) - WIN_LENGTH) // HOP_LENGTH, 0)
    return subsampled_length(frames)


def _on(a, device: torch.device) -> torch.Tensor:
    """A length or token array as a tensor on `device`, queued without a
    host sync: host arrays (and CPU tensors) through device.upload, a tensor
    already on `device` as it is."""
    if not torch.is_tensor(a):
        return upload(np.asarray(a), device)
    if a.device == device:
        return a
    return upload(a.numpy(), device) if a.device.type == "cpu" else a.to(device)


def ctc_losses(log_probs, enc_lens, tokens, token_lens, blank_id: int) -> torch.Tensor:
    """Per-sequence CTC NLL [B] as optax.ctc_loss gives it (ops/ctc.py
    ctc_loss: infeasible rows finite, the gradient autodiff's). Lengths and
    tokens may be host arrays or tensors; they are uploaded without a host
    sync."""
    dev = log_probs.device
    return ctc_loss(log_probs, _on(enc_lens, dev), _on(tokens, dev), _on(token_lens, dev),
                    blank_id)


def ctc_loss_fn(log_probs, enc_lens, tokens, token_lens, blank_id: int) -> torch.Tensor:
    """Mean per-sequence CTC NLL over a padded batch."""
    return ctc_losses(log_probs, enc_lens, tokens, token_lens, blank_id).mean()


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The step's generator on `device`, seeded from (seed + 1, step) (JAX:
    fold_in(PRNGKey(seed + 1), step))."""
    state = np.random.SeedSequence([seed + 1, step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _upload_batch(batch, device: torch.device):
    audio, audio_lens = batch[0], batch[1]
    return upload(np.asarray(audio, np.float32), device), upload(
        np.asarray(audio_lens, np.int32), device)


def make_train_step(blank_id: int, freeze_bn: bool = False):
    """freeze_bn=True runs BatchNorm with frozen running statistics while
    dropout stays live — continuation training on a shifted input
    distribution (window crops, in-length silence) otherwise drifts the
    running stats that inference depends on (tilawa_tpu train.py:68-79).

    The step takes a numpy batch (audio, audio_lens, tokens, token_lens)
    and returns the loss as a device tensor. As the JAX package's jitted
    step takes its sharding from its inputs, this one takes it from the
    model: where parallel/sharding.py shard_variables has placed the
    model's variables on a mesh (`model.axes` set), every rank gives the
    same global batch and generator, uploads its rows, takes its share of
    the global mean CTC loss on local tensors (ctc_loss takes no DTensor),
    reduces the gradients and returns the global loss."""

    def train_step(state: TrainState, batch, generator: torch.Generator) -> torch.Tensor:
        model, opt = state.model, state.optimizer
        axes = model.axes
        global_rows = len(batch[1])
        if axes is not None:
            batch = tuple(np.asarray(a)[axes.rows(global_rows)] for a in batch)
        _audio, audio_lens, tokens, token_lens = batch
        audio, lengths = _upload_batch(batch, model.mel_window.device)
        opt.zero_grad()
        log_probs, _enc = model(
            audio, lengths, deterministic=False, use_running_average=freeze_bn,
            generator=generator,
        )
        if axes is None:
            loss = ctc_loss_fn(log_probs, encoder_lengths(audio_lens), tokens, token_lens,
                               blank_id)
        else:
            loss = ctc_losses(log_probs, encoder_lengths(audio_lens), tokens, token_lens,
                              blank_id).sum() / global_rows
        loss.backward()
        if axes is not None:
            from tilawa_tpu_torch.parallel.sharding import reduce_gradients

            reduce_gradients(model)
            loss = axes.data_sum(loss.detach())
        opt.step()
        state.step += 1
        return loss.detach()

    return train_step


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """jax.nn.initializers.lecun_normal's distribution on the CPU: a normal
    truncated at ±2σ with σ = 1/sqrt(fan_in)/0.8796 (the truncation's std
    correction), drawn by inverse CDF from `generator`."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    w = torch.empty(shape).uniform_(lo, hi, generator=generator).erfinv_()
    return w.mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


@torch.no_grad()
def init_params(model: FastConformerCTC, seed: int = 0) -> FastConformerCTC:
    """flax's default initializers: Dense and Conv kernels lecun normal
    (truncated at ±2σ, σ = 1/sqrt(fan_in)/0.8796, fan_in over the kernel's
    inputs and taps), biases, norm offsets and u/v biases zero, norm scales
    one; BatchNorm running mean 0, var 1. Draws from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            fan_in = p.shape[0] if p.dim() == 2 else math.prod(p.shape[1:])
            p.copy_(lecun_normal(p.shape, fan_in, gen))
        elif name.endswith("scale"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, buf in model.named_buffers():
        if name.endswith(".mean"):
            buf.zero_()
        elif name.endswith(".var"):
            buf.fill_(1.0)
    return model


def init_state(config: FastConformerConfig, seed: int = 0, device="cuda") -> FastConformerCTC:
    """A freshly initialized model on `device` (flax's init distributions)."""
    if config.quant is not None:
        raise ValueError(f"a quantized ({config.quant}) config cannot be trained")
    return init_params(FastConformerCTC(config), seed).to(resolve_device(device))


def train(
    config: FastConformerConfig,
    batches: Iterator,
    steps: int,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 20,
    checkpoint_dir: str | Path | None = None,
    checkpoint_every: int = 500,
    init_from: str | Path | None = None,
    freeze_bn: bool = False,
    warmup_steps: int = 100,
    device: str | torch.device = "cuda",
    callback: Callable | None = None,
    mesh=None,
):
    """Run the training loop; returns (model, final state, loss history).

    init_from: checkpoint dir to warm-start params/batch_stats from (fresh
    optimizer state — continuation training, not exact resume). callback,
    if given, is called after every step as callback(i, state, batch,
    loss) with the loss still on the device. mesh: a parallel/mesh.py
    mesh that this process is a rank of (device: the rank's own); every
    rank runs train() with the same arguments and batches, the variables
    are sharded on the mesh and the results equal train() without one.
    Rank 0 alone prints and writes checkpoints."""
    from tilawa_tpu_torch.models.convert import load_into

    dev = resolve_device(device)
    model = init_state(config, seed=seed, device=dev)
    if init_from:
        from tilawa_tpu_torch.train.checkpoint import load_variables

        ckpt_config, variables = load_variables(init_from)
        if ckpt_config != config:
            raise ValueError(f"init_from config mismatch: {ckpt_config} != {config}")
        load_into(model, variables)
    lead = True
    if mesh is not None:
        from tilawa_tpu_torch.parallel.sharding import shard_variables

        shard_variables(model, mesh)
        lead = torch.distributed.get_rank() == 0
    optimizer = make_optimizer(model.parameters(), lr=lr, total_steps=steps,
                               warmup_steps=warmup_steps)
    state = TrainState(model, optimizer)
    step_fn = make_train_step(config.blank_id, freeze_bn=freeze_bn)

    history: list[float] = []
    t0 = time.time()
    for i in range(steps):
        batch = next(batches)
        loss = step_fn(state, batch, step_generator(seed, i, dev))
        if callback is not None:
            callback(i, state, batch, loss)
        if i % log_every == 0 or i == steps - 1:
            lv = float(loss)
            history.append(lv)
            shape = batch[0].shape
            if lead:
                print(
                    f"step {i:5d}  loss {lv:8.4f}  "
                    f"[{shape[0]}x{shape[1]//16000}s]  ({time.time()-t0:.0f}s)", flush=True,
                )
        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            _save(checkpoint_dir, config, model, i + 1)
    if checkpoint_dir:
        _save(checkpoint_dir, config, model, steps)
    return model, state, history


def _save(checkpoint_dir, config, model, step) -> Path | None:
    """Write the model's variables as a checkpoint. A sharded model's
    full tensors are gathered on every rank (a collective) and rank 0
    alone writes them; the other ranks return None."""
    from tilawa_tpu_torch.models.convert import variables_from_torch
    from tilawa_tpu_torch.train.checkpoint import save_variables

    state = model.state_dict()
    if model.axes is not None:
        state = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                 for k, v in state.items()}
        if torch.distributed.get_rank() != 0:
            return None
    path = save_variables(Path(checkpoint_dir) / f"step_{step:06d}", config,
                          variables_from_torch(state))
    print(f"checkpoint -> {path}", flush=True)
    return path


def main(argv=None):  # pragma: no cover - CLI
    import argparse

    from tilawa_tpu_torch.train.data import bucketed_corpus_batches, corpus_batches

    parser = argparse.ArgumentParser(description="tilawa-tpu CTC training (PyTorch)")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--preset", default="small", choices=["small", "large"])
    parser.add_argument("--checkpoint-dir", default="checkpoints/run")
    parser.add_argument("--checkpoint-every", type=int, default=500)
    parser.add_argument(
        "--corpora", default="v1",
        help="comma-separated corpora; >1 or 'all' selects bucketed batches",
    )
    parser.add_argument("--init-from", default=None)
    parser.add_argument("--no-augment", action="store_true")
    parser.add_argument("--weighting", default="prop", choices=["prop", "sqrt", "uniform"])
    parser.add_argument("--crop-prob", type=float, default=0.0,
                        help="fraction of examples replaced by forced-alignment window "
                             "crops (streaming robustness; see train/finetune.py)")
    parser.add_argument("--dropout", type=float, default=None, help="override config dropout")
    parser.add_argument("--specaug", action="store_true",
                        help="enable SpecAugment (2 freq masks, 10 time masks <=5%% of "
                             "valid length — ops/specaug.py)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only-ids", default=None,
                        help="JSON from train.fit_report (or comma list): restrict "
                             "training to these sample ids")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.init_from:
        from tilawa_tpu_torch.train.checkpoint import load_config

        config = load_config(args.init_from)
    else:
        config = (FastConformerConfig.small() if args.preset == "small"
                  else FastConformerConfig.large())
    if args.dropout is not None and args.dropout != config.dropout:
        config = dataclasses.replace(config, dropout=args.dropout)
    if args.specaug:
        config = dataclasses.replace(config, sa_freq_masks=2, sa_time_masks=10,
                                     sa_time_frac=0.05)
    corpora = ("v1", "v2", "v3") if args.corpora == "all" else tuple(args.corpora.split(","))
    if len(corpora) > 1:
        only_ids = None
        if args.only_ids:
            import json

            if Path(args.only_ids).exists():
                only_ids = {r["id"] for r in json.loads(Path(args.only_ids).read_text())}
            else:
                only_ids = set(args.only_ids.split(","))
        batches = bucketed_corpus_batches(
            corpora=corpora, augment=not args.no_augment, weighting=args.weighting,
            only_ids=only_ids, crop_prob=args.crop_prob, seed=args.seed,
        )
    else:
        batches = corpus_batches(batch_size=args.batch_size, corpus=corpora[0])
    train(
        config, batches, args.steps, lr=args.lr, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        init_from=args.init_from, warmup_steps=max(100, args.steps // 20),
        device=args.device,
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
