"""Checkpoint save/load for model variables.

Port of tilawa_tpu/train/checkpoint.py: a checkpoint directory holds
`config.json` (every FastConformerConfig field, the dtype by name, as
`FastConformerConfig(**cfg)` in the JAX package reads it) and
`variables.msgpack` (flax's msgpack layout, written by io/bundle.packb in
the tree's own key order and read by io/bundle.unpackb), so either package
reads the other's checkpoints. Trees are numpy leaves in the bundle layout;
models/convert.py maps them to and from a torch state dict.
"""

from __future__ import annotations

from pathlib import Path

from tilawa_tpu_torch.io.bundle import (  # noqa: F401 (re-exports)
    CHECKPOINT_DIR,
    EXPORTS_DIR,
    latest_checkpoint,
    load_variables,
    packb,
    shipped_checkpoint,
)
from tilawa_tpu_torch.models.fastconformer import FastConformerConfig


def save_variables(path: str | Path, config: FastConformerConfig, variables: dict) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(config.to_json())
    (path / "variables.msgpack").write_bytes(packb(variables))
    return path


def load_config(path: str | Path) -> FastConformerConfig:
    return FastConformerConfig.from_json(Path(path) / "config.json")
