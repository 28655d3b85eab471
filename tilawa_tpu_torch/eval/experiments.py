"""Runtime loading for the port's experiments.

Counterpart of tilawa_tpu/eval/experiments.py:_load_runtime: a bundle
(the shipped checkpoint, exports/champion-int4 unless TILAWA_CHECKPOINT
names another, or a path) on an EncoderRuntime. Recognizer(load_champion(),
tta=True) is the c2c-direct-mixed-tta pipeline; load_runtime("exports/
stream6-int8") is the streaming model.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from tilawa_tpu_torch.io.bundle import load_variables, shipped_checkpoint
from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime


def load_runtime(
    path: str | Path | None = None,
    device: str | torch.device = "cuda",
    long_chunking: bool | None = None,
) -> EncoderRuntime:
    """The bundle at `path` (default: the shipped checkpoint) on `device`.
    long_chunking defaults to TILAWA_LONG_CHUNKING, as in the JAX package."""
    ckpt = Path(path) if path is not None else shipped_checkpoint()
    if ckpt is None:
        raise FileNotFoundError("no export bundle found (set TILAWA_CHECKPOINT)")
    if long_chunking is None:
        long_chunking = os.getenv("TILAWA_LONG_CHUNKING", "") not in ("", "0", "false")
    config, variables = load_variables(ckpt)
    return EncoderRuntime(config, variables, device=device, long_chunking=long_chunking)


def load_champion(device: str | torch.device = "cuda") -> EncoderRuntime:
    return load_runtime(device=device, long_chunking=False)
