"""Depth pruning: drop conformer layers from a trained checkpoint.

Port of tilawa_tpu/train/prune.py. The reference's pruning family builds
12/8/6-layer variants of a trained encoder, selecting either the first N
layers or an evenly spaced subset (reference:
experiments/rabah-pruned-ctc/run.py:1-344). Bundles hold the depth axis
scan-stacked, so pruning slices axis 0 of every leaf under `blocks` of the
numpy variables tree that io/bundle loads (int4 `packed`/`scales` leaves
included), before models/convert.py maps the tree onto the torch modules:
the pruned config's `num_layers` gives the model as many blocks.

  python -m tilawa_tpu_torch.train.prune --checkpoint exports/champion-int4 \\
      --out checkpoints/pruned-L12 --keep 12
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tilawa_tpu_torch.models.fastconformer import FastConformerConfig


def layer_indices(total: int, keep: int, mode: str = "evenly_spaced") -> list[int]:
    """Which source layers survive (reference modes: first_n | evenly_spaced)."""
    if keep >= total:
        return list(range(total))
    if mode == "first_n":
        return list(range(keep))
    if mode == "evenly_spaced":
        return sorted({round(i * (total - 1) / max(keep - 1, 1)) for i in range(keep)})
    raise ValueError(f"unknown prune mode {mode!r}")


def prune_layers(
    config: FastConformerConfig,
    variables: dict,
    keep: int,
    mode: str = "evenly_spaced",
) -> tuple[FastConformerConfig, dict]:
    """Slice the scan-stacked depth axis down to `keep` layers. The result
    is a new tree of numpy arrays (the sliced leaves are copies; the others
    are the source's arrays)."""
    if not config.scan_layers:
        raise ValueError("prune_layers requires scan-stacked variables")
    idx = np.asarray(layer_indices(config.num_layers, keep, mode))
    new_config = dataclasses.replace(config, num_layers=len(idx))

    def walk(tree, under_blocks=False):
        out = {}
        for name, sub in tree.items():
            inside = under_blocks or name == "blocks"
            if isinstance(sub, dict):
                out[name] = walk(sub, inside)
            elif inside and hasattr(sub, "shape") and sub.ndim >= 1 and (
                sub.shape[0] == config.num_layers
            ):
                out[name] = np.asarray(sub)[idx]
            else:
                out[name] = sub
        return out

    return new_config, {k: walk(v) for k, v in variables.items()}


def prune_checkpoint(
    checkpoint: str,
    out_dir: str,
    keep: int,
    mode: str = "evenly_spaced",
):
    from tilawa_tpu_torch.train.checkpoint import load_variables, save_variables

    config, variables = load_variables(checkpoint)
    new_config, new_vars = prune_layers(config, variables, keep, mode)
    return save_variables(out_dir, new_config, new_vars)


def main(argv=None):  # pragma: no cover - CLI
    import argparse

    parser = argparse.ArgumentParser(description="depth-prune a checkpoint")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--keep", type=int, required=True)
    parser.add_argument("--mode", default="evenly_spaced",
                        choices=["first_n", "evenly_spaced"])
    args = parser.parse_args(argv)
    out = prune_checkpoint(args.checkpoint, args.out, args.keep, args.mode)
    print(f"pruned checkpoint -> {out}")


if __name__ == "__main__":  # pragma: no cover
    main()
