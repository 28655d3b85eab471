"""Runtime loading for the port's experiments.

Counterpart of tilawa_tpu/eval/experiments.py:_load_runtime for the
champion family: the shipped checkpoint (exports/champion-int4 unless
TILAWA_CHECKPOINT names another) on an EncoderRuntime. Recognizer(
load_champion(), tta=True) is the c2c-direct-mixed-tta pipeline.
"""

from __future__ import annotations

import torch

from tilawa_tpu_torch.io.bundle import load_variables, shipped_checkpoint
from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime


def load_champion(device: str | torch.device = "cuda") -> EncoderRuntime:
    ckpt = shipped_checkpoint()
    if ckpt is None:
        raise FileNotFoundError("no export bundle found (set TILAWA_CHECKPOINT)")
    config, variables = load_variables(ckpt)
    return EncoderRuntime(config, variables, device=device)
