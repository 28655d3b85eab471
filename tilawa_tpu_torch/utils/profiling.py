"""Env-gated stage timers (reference: C2C_DIRECT_MIXED_PROFILE prints
forward/decode/build/rerank wall-times — c2c-direct-mixed/run.py:34,117-124).

Enable with TILAWA_PROFILE=1. `stage("name")` contexts accumulate into a
per-thread table; `report()` renders it. A copy of
tilawa_tpu/utils/profiling.py; the port's Recognizer keeps its stage times
in its own `last_profile`.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

ENABLED = os.getenv("TILAWA_PROFILE", "") not in ("", "0", "false")

_local = threading.local()


def _table() -> dict[str, list[float]]:
    if not hasattr(_local, "table"):
        _local.table = {}
    return _local.table


@contextmanager
def stage(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _table().setdefault(name, []).append(time.perf_counter() - t0)


def reset() -> None:
    _table().clear()


def report() -> str:
    rows = []
    for name, values in sorted(_table().items()):
        total = sum(values)
        rows.append(
            f"{name:<16} n={len(values):<4} total={total:7.3f}s "
            f"mean={total / len(values):7.4f}s max={max(values):7.4f}s"
        )
    return "\n".join(rows)


def print_report() -> None:
    if ENABLED and _table():
        print("[tilawa profile]\n" + report())
