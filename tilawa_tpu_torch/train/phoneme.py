"""Phoneme-head fine-tune: champion encoder + fresh 69-token CTC head.

Port of tilawa_tpu/train/phoneme.py. The reference's browser-shipped model
was exactly this: the Arabic-text FastConformer with its CTC head swapped
to a 69-token Buckwalter phoneme vocabulary and fine-tuned on phoneme
targets (reference: experiments/fastconformer-phoneme/run.py:42-55;
training: scripts/train_fastconformer_phoneme_modal.py _PhonemeTokenizer
injection, lines 940-982). Here: dequantize the champion export,
re-initialize `ctc_head` for vocab 69 (+ blank 69), and continue CTC
training against PhonemeStore targets built from quran_phonemes.json. An
--init that is already a phoneme checkpoint (exports/phoneme-int8) keeps
its trained head (continuation training).

The fresh head is lecun-normal from an explicit torch.Generator(seed), as
jax.nn.initializers.lecun_normal draws it: the same distribution, not the
same bits as the JAX package's PRNGKey(seed).

Usage (on the card unless --device cpu):
  python -m tilawa_tpu_torch.train.phoneme --steps 3000 \\
      --checkpoint-dir checkpoints/phoneme
  python -m tilawa_tpu_torch.train.phoneme --device cpu --preset small \\
      --steps 2 --corpora v1 --checkpoint-dir checkpoints/phoneme_tiny
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from tilawa_tpu_torch.data.phonemes import PhonemeStore
from tilawa_tpu_torch.train.data import BUCKETS, pad_batch


def phoneme_corpus_batches(
    corpora: tuple[str, ...] = ("v1", "v2", "v3"),
    seed: int = 0,
    augment: bool = True,
    weighting: str = "sqrt",
    aug_strength: str = "base",
):
    """Length-bucketed batches of (audio, phoneme-id targets)."""
    from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
    from tilawa_tpu_torch.eval.runner import load_manifest
    from tilawa_tpu_torch.train.data import _augment

    store = PhonemeStore.load_default()
    examples: list[tuple[np.ndarray, list[int]]] = []
    for corpus in corpora:
        try:
            samples, corpus_dir = load_manifest(corpus)
        except FileNotFoundError:
            continue
        for s in samples:
            path = corpus_dir / s["file"]
            if not path.exists():
                continue
            try:
                audio = load_audio(path)
            except UnsupportedAudioFormat:
                continue
            if len(audio) > BUCKETS[-1][0] * 16000:
                continue
            ids: list[int] = []
            for e in s.get(
                "expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}]
            ):
                verse_ids = store.verse_ids(e["surah"], e["ayah"])
                if verse_ids:
                    if ids:
                        ids.append(store.encode_phonemes("|")[0])
                    ids.extend(verse_ids)
            if ids:
                examples.append((audio, ids))
    if not examples:
        raise RuntimeError("no phoneme training examples found")

    by_bucket: list[list[tuple[np.ndarray, list[int]]]] = [[] for _ in BUCKETS]
    for a, ids in examples:
        for bi, (sec, _bs) in enumerate(BUCKETS):
            if len(a) <= sec * 16000:
                by_bucket[bi].append((a, ids))
                break
    live = [bi for bi, ex in enumerate(by_bucket) if ex]
    token_pads = [
        int(np.ceil(max((len(i) for _a, i in ex), default=8) / 16) * 16)
        for ex in by_bucket
    ]
    weights = np.array([len(by_bucket[bi]) for bi in live], dtype=np.float64)
    if weighting == "sqrt":
        weights = np.sqrt(weights)
    elif weighting == "uniform":
        weights = np.ones_like(weights)
    weights /= weights.sum()

    rng = np.random.default_rng(seed)
    while True:
        bi = int(rng.choice(live, p=weights))
        sec, bs = BUCKETS[bi]
        pad = int(sec * 16000)
        pool = by_bucket[bi]
        picks = rng.choice(len(pool), size=min(bs, len(pool)), replace=len(pool) < bs)
        chunk = []
        for i in picks:
            a, ids = pool[int(i)]
            if augment:
                a = _augment(a, rng, pad, strength=aug_strength)
            chunk.append((a, ids))
        while len(chunk) < bs:
            chunk.append(chunk[len(chunk) % max(1, len(picks))])
        yield pad_batch(chunk, pad, token_pads[bi])


def swap_head_for_phonemes(config, variables, num_classes: int, seed: int = 0):
    """Replace the trained text CTC head with a fresh phoneme head:
    kernel [d_model, num_classes] lecun-normal from torch.Generator(seed),
    bias 0; config vocab_size num_classes - 1 (blank last)."""
    from tilawa_tpu_torch.train.train import lecun_normal

    d = config.d_model
    gen = torch.Generator().manual_seed(seed)
    params = dict(variables["params"])
    params["ctc_head"] = {
        "kernel": lecun_normal((d, num_classes), d, gen).numpy(),
        "bias": np.zeros(num_classes, np.float32),
    }
    new_vars = dict(variables)
    new_vars["params"] = params
    new_config = dataclasses.replace(config, vocab_size=num_classes - 1)
    return new_config, new_vars


def prepare_init(init: str | Path, seed: int = 0, config=None, variables=None):
    """(config, variables) to train from: `init` dequantized when it is a
    quantized bundle, its head kept when it is already a phoneme checkpoint,
    else swapped for a fresh phoneme head. config/variables, when given,
    stand in for the checkpoint at `init`."""
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config

    store = PhonemeStore.load_default()
    if config is None:
        config, variables = load_variables(init)
    if config.quant:
        print(f"dequantizing {init} for continuation", flush=True)
        variables = dequantize_variables(variables)
        config = dequantized_config(config)
    if config.vocab_size == store.num_classes - 1:  # head outputs vocab+blank
        # already a phoneme checkpoint (continuation training) — keep the
        # trained head instead of re-initializing it
        print(f"continuing phoneme training from {init}", flush=True)
    else:
        config, variables = swap_head_for_phonemes(
            config, variables, store.num_classes, seed=seed
        )
        print(f"phoneme head: {store.num_classes} classes "
              f"(blank {store.blank_id})", flush=True)
    return config, variables


def train_phoneme(
    init: str | Path = "exports/champion-int4",
    checkpoint_dir: str | Path = "checkpoints/phoneme",
    steps: int = 3000,
    lr: float = 1e-4,
    corpora: tuple[str, ...] = ("v1", "v2", "v3"),
    checkpoint_every: int = 500,
    seed: int = 0,
    aug_strength: str = "base",
    device: str = "cuda",
    log_every: int = 20,
    config=None,
    variables=None,
    callback=None,
):
    """The recipe end to end; returns train()'s (model, state, history)."""
    from tilawa_tpu_torch.train.checkpoint import save_variables
    from tilawa_tpu_torch.train.train import train

    config, variables = prepare_init(init, seed, config, variables)
    init_dir = Path(checkpoint_dir) / "init"
    save_variables(init_dir, config, variables)
    batches = phoneme_corpus_batches(
        corpora=tuple(corpora), seed=seed, aug_strength=aug_strength,
    )
    return train(
        config, batches, steps=steps, lr=lr, seed=seed,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        init_from=init_dir, freeze_bn=True,
        warmup_steps=max(100, steps // 10), device=device, log_every=log_every,
        callback=callback,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="phoneme-head finetune (PyTorch)")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--init", default="exports/champion-int4")
    parser.add_argument("--corpora", default="v1,v2,v3")
    parser.add_argument("--checkpoint-dir", default="checkpoints/phoneme")
    parser.add_argument("--checkpoint-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--aug-strength", default="base", choices=["base", "strong"])
    parser.add_argument("--preset", default=None, choices=[None, "small"],
                        help="small: a random-init small text model in place of "
                             "--init, its head swapped (CPU smoke runs)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    config = variables = None
    if args.preset == "small":
        from tilawa_tpu_torch.models.convert import variables_from_torch
        from tilawa_tpu_torch.models.fastconformer import FastConformerConfig
        from tilawa_tpu_torch.train.train import init_state

        config = FastConformerConfig.small()
        variables = variables_from_torch(init_state(config, seed=args.seed, device="cpu"))
    train_phoneme(
        init=args.init, checkpoint_dir=args.checkpoint_dir, steps=args.steps, lr=args.lr,
        corpora=tuple(args.corpora.split(",")), checkpoint_every=args.checkpoint_every,
        seed=args.seed, aug_strength=args.aug_strength, device=args.device,
        config=config, variables=variables,
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
