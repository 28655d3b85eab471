"""Streaming-robustness continuation training from the int4 champion.

Port of tilawa_tpu/train/finetune.py, with its recipe: warm-start from the
dequantized champion export, dropout 0.1, SpecAugment (2 frequency masks,
10 time masks of up to 5% of the valid length), frozen BatchNorm, lr 3e-5
with warmup max(100, steps/10), and a mixture of full clips and
forced-alignment window crops (crop_prob 0.35; train/data.py
random_window_crop). Why each choice: the JAX module's docstring (a live-BN
lr-1e-4 run collapsed full-clip accuracy; the champion, trained at dropout
0, memorizes full-utterance context).

Usage (on the card unless --device cpu):
  python -m tilawa_tpu_torch.train.finetune --steps 2000 \\
      --checkpoint-dir checkpoints/stream2
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path


def finetune(
    init: str | Path = "exports/champion-int4",
    checkpoint_dir: str | Path = "checkpoints/stream2",
    steps: int = 2000,
    lr: float = 3e-5,
    crop_prob: float = 0.35,
    dropout: float = 0.1,
    specaug: bool = True,
    live_bn: bool = False,
    seed: int = 0,
    corpora: tuple[str, ...] = ("v1", "v2", "v3"),
    aug_strength: str = "base",
    weighting: str = "prop",
    checkpoint_every: int = 250,
    device: str = "cuda",
    log_every: int = 20,
    callback=None,
):
    """The recipe end to end; returns train()'s (model, state, history)."""
    from tilawa_tpu_torch.train.checkpoint import load_variables, save_variables
    from tilawa_tpu_torch.train.data import bucketed_corpus_batches
    from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config
    from tilawa_tpu_torch.train.train import train

    config, variables = load_variables(init)
    if config.quant:
        print(f"dequantizing {init} ({config.quant}) for continuation", flush=True)
        variables = dequantize_variables(variables)
        config = dequantized_config(config)
    if dropout != config.dropout:
        # dropout is stateless — safe to change for continuation training
        config = dataclasses.replace(config, dropout=dropout)
    if specaug:
        # only active when deterministic=False: inference is unchanged
        config = dataclasses.replace(config, sa_freq_masks=2, sa_time_masks=10,
                                     sa_time_frac=0.05)
    init_dir = Path(checkpoint_dir) / "init"
    save_variables(init_dir, config, variables)

    batches = bucketed_corpus_batches(
        corpora=tuple(corpora), seed=seed, crop_prob=crop_prob,
        aug_strength=aug_strength, weighting=weighting,
    )
    return train(
        config, batches, steps=steps, lr=lr, seed=seed,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        init_from=init_dir, freeze_bn=not live_bn,
        warmup_steps=max(100, steps // 10), device=device, log_every=log_every,
        callback=callback,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="streaming finetune (PyTorch)")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=3e-5)
    parser.add_argument("--crop-prob", type=float, default=0.35)
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--no-specaug", dest="specaug", action="store_false",
                        help="disable SpecAugment (default: on)")
    parser.add_argument("--live-bn", action="store_true",
                        help="update BatchNorm running stats (default: frozen)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--corpora", default="v1,v2,v3")
    parser.add_argument("--aug-strength", default="base", choices=["base", "strong"])
    parser.add_argument("--weighting", default="prop", choices=["prop", "sqrt", "uniform"])
    parser.add_argument("--init", default="exports/champion-int4")
    parser.add_argument("--checkpoint-dir", default="checkpoints/stream2")
    parser.add_argument("--checkpoint-every", type=int, default=250)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    finetune(
        init=args.init, checkpoint_dir=args.checkpoint_dir, steps=args.steps, lr=args.lr,
        crop_prob=args.crop_prob, dropout=args.dropout, specaug=args.specaug,
        live_bn=args.live_bn, seed=args.seed, corpora=tuple(args.corpora.split(",")),
        aug_strength=args.aug_strength, weighting=args.weighting,
        checkpoint_every=args.checkpoint_every, device=args.device,
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
