"""Frame-level self-distillation for streaming robustness.

Port of tilawa_tpu/train/distill.py. The student sees a CROPPED window
while the TEACHER (the batch champion) sees the FULL clip, and the student
is trained to reproduce the teacher's frame-level posteriors over the
crop's frames (masked KL(teacher || student)) plus an auxiliary per-token
CTC on the crop's forced-alignment labels. Crop starts are snapped to the
1280-sample encoder frame stride (mel hop 160 x subsampling 8), so student
frame t is teacher frame t + crop_start/1280.

The host side (snap_crop, distill_batches) is a numpy copy: the same seed
gives the JAX package's batches bit for bit. The step runs the teacher
under torch.no_grad() — not inference_mode(): the KL keeps the teacher's
log-probs for the backward pass, and an inference tensor cannot be saved
for it. The teacher runs as its checkpoint stores it: a quantized export
(exports/champion-int4) on the int4 kernel, 189 launches a forward. (The
JAX package dequantizes a quantized teacher to fp Dense layers; the int4
kernel computes the same bf16 weights and bf16 products, summed in another
order.) The student is dequantized for training; BatchNorm stays frozen.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from tilawa_tpu_torch.device import resolve_device, upload
from tilawa_tpu_torch.models.fastconformer import FastConformerCTC
from tilawa_tpu_torch.train.train import (
    TrainState,
    ctc_losses,
    encoder_lengths,
    make_optimizer,
    step_generator,
)

# encoder frame stride in audio samples: mel hop 160 x subsampling 8
FRAME_STRIDE = 1280
# distill_batches' default buckets: train.data.BUCKETS up to this length
MAX_BUCKET_S = 48.0


def _ctc_per_token(log_probs, enc_lens, tokens, token_lens, blank_id: int) -> torch.Tensor:
    """CTC NLL normalized per label token (mean over the batch)."""
    losses = ctc_losses(log_probs, enc_lens, tokens, token_lens, blank_id)
    per = upload(np.maximum(np.asarray(token_lens), 1).astype(np.float32), losses.device)
    return (losses / per).mean()


# --------------------------------------------------------------------------
# batch construction (host side)


def snap_crop(
    audio: np.ndarray,
    ids: list[int],
    spans: np.ndarray,
    rng: np.random.Generator,
    min_crop_s: float = 1.2,
) -> tuple[int, int, list[int]]:
    """Pick a window like train.data.random_window_crop but return
    (start, length, kept_ids) with start/end snapped to FRAME_STRIDE so the
    student's encoder frames land exactly on teacher frames.

    Cut points are inter-token gap midpoints (a cut through a token leaves
    audible speech labelled as nothing — see random_window_crop)."""
    sr = 16000
    n = len(audio)
    L = len(ids)
    cuts = np.empty(L + 1, np.int64)
    cuts[0] = 0
    cuts[-1] = n
    if L > 1:
        cuts[1:-1] = (spans[:-1, 1] + spans[1:, 0]) // 2
    # snap to the frame grid (nearest multiple; gaps are >> 80 ms typically)
    cuts = np.clip((cuts + FRAME_STRIDE // 2) // FRAME_STRIDE * FRAME_STRIDE, 0, n)
    min_len = min(n, int(min_crop_s * sr))

    mode = rng.random()
    if mode < 0.4:          # prefix (discovery window)
        i0 = 0
        valid = np.nonzero(cuts - cuts[0] >= min_len)[0]
        i1 = int(rng.choice(valid)) if len(valid) else L
    elif mode < 0.6:        # suffix (post-trim tracking window)
        i1 = L
        valid = np.nonzero(cuts[-1] - cuts >= min_len)[0]
        i0 = int(rng.choice(valid)) if len(valid) else 0
    else:                   # interior window
        i0 = int(rng.integers(0, L))
        valid = np.nonzero(cuts - cuts[i0] >= min_len)[0]
        i1 = int(rng.choice(valid)) if len(valid) else L
    s0, s1 = int(cuts[i0]), int(cuts[i1])
    if s1 <= s0:
        return 0, n, list(ids)
    return s0, s1 - s0, [ids[i] for i in range(i0, i1)]


def distill_batches(
    corpora: tuple[str, ...] = ("v1", "v2", "v3"),
    seed: int = 0,
    augment: bool = True,
    crop_prob: float = 0.85,
    buckets: list[tuple[float, int]] | None = None,
    weighting: str = "sqrt",
    min_crop_s: float = 1.2,
) -> Iterator[tuple]:
    """Infinite iterator of distillation batches.

    Yields (audio [B,Npad] f32, audio_lens [B], crop_start [B],
    crop_len [B], tokens [B,L], token_lens [B]): full audio for the
    teacher, crop window + crop labels for the student. Samples without
    forced alignments (or drawn as full-window by 1-crop_prob) get
    crop_start=0, crop_len=audio_len — the student then sees exactly the
    teacher's input and the KL is a consistency term.

    Augmentation (speed/gain/noise — train.data._augment) applies to the
    FULL clip before the crop is taken, so teacher and student always see
    the same audio content.
    """
    from tilawa_tpu_torch.train.data import (
        BUCKETS, _attach_spans, _augment, load_corpus_examples,
    )

    buckets = buckets or [b for b in BUCKETS if b[0] <= MAX_BUCKET_S]
    raw = []
    for corpus in corpora:
        raw.extend(
            load_corpus_examples(
                corpus, max_audio_s=buckets[-1][0], return_ids=True
            )
        )
    if not raw:
        raise RuntimeError("no decodable training examples found")
    examples = _attach_spans(corpora, raw)

    by_bucket: list[list] = [[] for _ in buckets]
    for a, ids, spans in examples:
        for bi, (sec, _bs) in enumerate(buckets):
            if len(a) <= sec * 16000:
                by_bucket[bi].append((a, ids, spans))
                break
    live = [bi for bi, ex in enumerate(by_bucket) if ex]
    token_pads = []
    for ex in by_bucket:
        tp = max((len(ids) for _a, ids, _sp in ex), default=8)
        token_pads.append(int(np.ceil(tp / 16) * 16))
    weights = np.array([len(by_bucket[bi]) for bi in live], dtype=np.float64)
    if weighting == "sqrt":
        weights = np.sqrt(weights)
    elif weighting == "uniform":
        weights = np.ones_like(weights)
    weights /= weights.sum()

    rng = np.random.default_rng(seed)
    while True:
        bi = int(rng.choice(live, p=weights))
        sec, bs = buckets[bi]
        pad = int(sec * 16000)
        pool = by_bucket[bi]
        picks = rng.choice(
            len(pool), size=min(bs, len(pool)), replace=len(pool) < bs
        )
        rows = []
        for i in picks:
            a, ids, spans = pool[int(i)]
            if augment:
                a = _augment(a, rng, pad)
            a = a[:pad]
            if (
                spans is not None and len(spans) == len(ids) and len(spans)
                and rng.random() < crop_prob
            ):
                # spans were aligned on the un-augmented clip; speed perturb
                # rescales time. Rescale the spans by the actual length
                # ratio (gap midpoints just need to land in the gaps).
                sp = spans.astype(np.float64) * (len(a) / len(pool[int(i)][0]))
                s0, slen, kept = snap_crop(
                    a, ids, sp.astype(np.int64), rng, min_crop_s=min_crop_s
                )
            else:
                s0, slen, kept = 0, len(a), list(ids)
            rows.append((a, s0, slen, kept))
        while len(rows) < bs:
            rows.append(rows[len(rows) % max(1, len(picks))])

        b = len(rows)
        audio = np.zeros((b, pad), np.float32)
        audio_lens = np.zeros(b, np.int32)
        crop_start = np.zeros(b, np.int32)
        crop_len = np.zeros(b, np.int32)
        tokens = np.zeros((b, token_pads[bi]), np.int32)
        token_lens = np.zeros(b, np.int32)
        for i, (a, s0, slen, kept) in enumerate(rows):
            audio[i, : len(a)] = a
            audio_lens[i] = len(a)
            crop_start[i] = s0
            crop_len[i] = slen
            kept = kept[: token_pads[bi]]
            tokens[i, : len(kept)] = kept
            token_lens[i] = len(kept)
        yield audio, audio_lens, crop_start, crop_len, tokens, token_lens


# --------------------------------------------------------------------------
# the distillation step


def _slice_to_front(x: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Per-sample roll-to-front + zero beyond `length` along axis 1:
    out[b, i] = x[b, (i + start[b]) mod N] for i < length[b], else 0."""
    n = x.shape[1]
    idx = (torch.arange(n, device=x.device)[None, :] + start[:, None].long()) % n
    keep = torch.arange(n, device=x.device)[None, :] < length[:, None]
    if x.dim() == 2:
        return torch.where(keep, x.gather(1, idx), 0.0)
    rolled = x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))
    return torch.where(keep[..., None], rolled, 0.0)


def _pool_teacher_time(t_lp: torch.Tensor, pool: int) -> torch.Tensor:
    """Average teacher probabilities over a +-pool frame window (zero
    padded, as jnp.convolve's "same"), then re-log: CTC spikes may sit a
    frame or two apart between a full-context teacher and a partial-context
    student (tilawa_tpu distill.py:232)."""
    if pool <= 0:
        return t_lp
    k = 2 * pool + 1
    probs = torch.exp(t_lp).transpose(1, 2)                   # [B, V, T]
    pooled = F.avg_pool1d(probs, k, stride=1, padding=pool, count_include_pad=True)
    return torch.log(torch.clamp(pooled.transpose(1, 2), min=1e-10))


def make_distill_step(
    teacher: FastConformerCTC,
    blank_id: int,
    kl_weight: float = 1.0,
    ctc_weight: float = 0.3,
    teacher_pool: int = 0,
):
    """One step: teacher forward on the full audio (no grad), student
    forward on the crop (dropout live, BatchNorm frozen), masked frame-KL
    + auxiliary crop-CTC. Takes a numpy batch from distill_batches; returns
    (loss, kl, ctc) as device tensors."""

    def step(state: TrainState, batch, generator: torch.Generator):
        student, opt = state.model, state.optimizer
        audio, audio_lens, crop_start, crop_len, tokens, token_lens = batch
        dev = student.mel_window.device
        audio_t, lens_t = upload(audio, dev), upload(audio_lens, dev)
        start_t, crop_t = upload(crop_start, dev), upload(crop_len, dev)

        with torch.no_grad():
            t_lp, t_enc_lens = teacher(audio_t, lens_t)
            t_lp = _pool_teacher_time(t_lp, teacher_pool)
            frame_off = torch.div(start_t, FRAME_STRIDE, rounding_mode="floor")
            t_lp_crop = _slice_to_front(t_lp, frame_off, torch.full_like(frame_off, t_lp.shape[1]))
            student_audio = _slice_to_front(audio_t, start_t, crop_t)

        opt.zero_grad()
        s_lp, s_enc_lens = student(student_audio, crop_t, deterministic=False,
                                   use_running_average=True, generator=generator)
        t = s_lp.shape[1]
        # valid student frames that also exist in the teacher's clip
        frames_ok = torch.minimum(s_enc_lens, torch.clamp(t_enc_lens - frame_off, min=0))
        mask = (torch.arange(t, device=dev)[None, :] < frames_ok[:, None]).float()
        tl = t_lp_crop[:, :t, :]
        kl = torch.sum(torch.exp(tl) * (tl - s_lp), dim=-1)     # [B, T] KL(teacher || student)
        kl = torch.sum(kl * mask) / torch.clamp(torch.sum(mask), min=1.0)
        # per-TOKEN CTC so the two terms share a scale
        ctc = _ctc_per_token(s_lp, encoder_lengths(crop_len), tokens, token_lens, blank_id)
        loss = kl_weight * kl + ctc_weight * ctc
        loss.backward()
        opt.step()
        state.step += 1
        return loss.detach(), kl.detach(), ctc.detach()

    return step


def load_teacher(teacher_ckpt: str | Path, device) -> FastConformerCTC:
    """The teacher as its checkpoint stores it, frozen, on `device`."""
    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.train.checkpoint import load_variables

    t_cfg, t_vars = load_variables(teacher_ckpt)
    teacher = load_into(FastConformerCTC(t_cfg), t_vars).to(device).eval()
    return teacher.requires_grad_(False)


def train_distill(
    student_init: str | Path,
    teacher_ckpt: str | Path,
    batches: Iterator,
    steps: int,
    lr: float = 3e-5,
    seed: int = 0,
    checkpoint_dir: str | Path | None = None,
    checkpoint_every: int = 500,
    kl_weight: float = 1.0,
    ctc_weight: float = 0.3,
    teacher_pool: int = 0,
    log_every: int = 20,
    dropout: float = 0.1,
    device: str | torch.device = "cuda",
    callback=None,
):
    """Distillation loop; returns (state, history). student_init may be a
    quantized export (dequantized for training). callback, if given, is
    called after every step as callback(i, state, batch, (loss, kl, ctc))."""
    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config

    dev = resolve_device(device)
    s_cfg, s_vars = load_variables(student_init)
    if s_cfg.quant:
        s_vars = dequantize_variables(s_vars)
        s_cfg = dequantized_config(s_cfg)
    s_cfg = dataclasses.replace(s_cfg, dropout=dropout)
    student = load_into(FastConformerCTC(s_cfg), s_vars).to(dev)
    teacher = load_teacher(teacher_ckpt, dev)
    opt = make_optimizer(student.parameters(), lr=lr, total_steps=steps,
                         warmup_steps=max(100, steps // 20))
    state = TrainState(student, opt)
    step_fn = make_distill_step(teacher, s_cfg.blank_id, kl_weight=kl_weight,
                                ctc_weight=ctc_weight, teacher_pool=teacher_pool)

    history = []
    t0 = time.time()
    for i in range(steps):
        batch = next(batches)
        out = step_fn(state, batch, step_generator(seed, i, dev))
        if callback is not None:
            callback(i, state, batch, out)
        if i % log_every == 0 or i == steps - 1:
            lv, klv, ctcv = (float(v) for v in out)
            history.append(lv)
            shape = batch[0].shape
            print(f"step {i:5d}  loss {lv:8.4f}  kl {klv:8.4f}  ctc {ctcv:8.2f}"
                  f"  [{shape[0]}x{shape[1]//16000}s]  ({time.time()-t0:.0f}s)", flush=True)
        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            _save(checkpoint_dir, s_cfg, student, i + 1)
    if checkpoint_dir:
        _save(checkpoint_dir, s_cfg, student, steps)
    return state, history


def _save(checkpoint_dir, config, model, step) -> Path:
    from tilawa_tpu_torch.models.convert import variables_from_torch
    from tilawa_tpu_torch.train.checkpoint import save_variables

    # checkpoints are inference artifacts: save with dropout 0
    path = save_variables(Path(checkpoint_dir) / f"step_{step:06d}",
                          dataclasses.replace(config, dropout=0.0),
                          variables_from_torch(model))
    print(f"checkpoint -> {path}", flush=True)
    return path


def main(argv=None) -> int:  # pragma: no cover - CLI
    import argparse

    parser = argparse.ArgumentParser(description="frame-level streaming self-distillation "
                                                 "(PyTorch)")
    parser.add_argument("--student-init", default="exports/stream6-int8")
    parser.add_argument("--teacher", default="exports/champion-int4")
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--lr", type=float, default=3e-5)
    parser.add_argument("--kl-weight", type=float, default=1.0)
    parser.add_argument("--ctc-weight", type=float, default=0.3)
    parser.add_argument("--teacher-pool", type=int, default=0,
                        help="+-K frame teacher probability pooling (tolerates CTC peak shift)")
    parser.add_argument("--crop-prob", type=float, default=0.85)
    parser.add_argument("--corpora", default="all")
    parser.add_argument("--checkpoint-dir", default="checkpoints/distill1")
    parser.add_argument("--checkpoint-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    corpora = ("v1", "v2", "v3") if args.corpora == "all" else tuple(args.corpora.split(","))
    batches = distill_batches(corpora=corpora, seed=args.seed, crop_prob=args.crop_prob)
    train_distill(
        args.student_init, args.teacher, batches, args.steps, lr=args.lr, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        kl_weight=args.kl_weight, ctc_weight=args.ctc_weight,
        teacher_pool=args.teacher_pool, dropout=args.dropout, device=args.device,
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
