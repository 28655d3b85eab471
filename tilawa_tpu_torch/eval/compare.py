"""Streaming-vs-batch comparison: separate tracker loss from model floor.

Port of the reference diagnostic (reference:
web/frontend/test/compare-streaming-oracle.ts:1-15) — given two runner
result files for the same corpus (one batch/"oracle" run, one streaming
run), classify every sample:

  both_exact        — streaming pipeline is lossless here
  streaming_loss    — batch exact, streaming wrong: tracker/windowing loss
  model_floor       — batch already wrong: matcher/acoustics floor
  streaming_rescue  — streaming exact where batch failed (rare)

A copy of tilawa_tpu/eval/compare.py.

Usage:
  python -m tilawa_tpu_torch.eval.compare batch.json streaming.json [--verbose]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from tilawa_tpu_torch.eval.analyze import _refs


def _per_sample(results: dict | list) -> dict[str, dict]:
    if isinstance(results, list):
        results = results[0]
    return {s["id"]: s for s in results.get("per_sample", [])}


def compare_results(batch: dict | list, streaming: dict | list) -> dict:
    b, s = _per_sample(batch), _per_sample(streaming)
    classes: dict[str, list[str]] = {
        "both_exact": [], "streaming_loss": [], "model_floor": [],
        "streaming_rescue": [],
    }
    detail = []
    for sid in sorted(set(b) & set(s)):
        expected = _refs(b[sid].get("expected", []))
        batch_got = _refs(b[sid].get("predicted", []))
        stream_got = _refs(s[sid].get("predicted", []))
        b_ok = batch_got == expected
        s_ok = stream_got == expected
        klass = (
            "both_exact" if b_ok and s_ok
            else "streaming_loss" if b_ok
            else "streaming_rescue" if s_ok
            else "model_floor"
        )
        classes[klass].append(sid)
        if klass != "both_exact":
            detail.append(
                {"id": sid, "class": klass, "expected": expected,
                 "batch": batch_got, "streaming": stream_got}
            )
    return {
        "common_samples": sum(len(v) for v in classes.values()),
        "counts": {k: len(v) for k, v in classes.items()},
        "classes": classes,
        "detail": detail,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="streaming-vs-batch results comparison"
    )
    parser.add_argument("batch", help="batch-mode runner results JSON")
    parser.add_argument("streaming", help="streaming-mode runner results JSON")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    rep = compare_results(
        json.loads(Path(args.batch).read_text(encoding="utf-8")),
        json.loads(Path(args.streaming).read_text(encoding="utf-8")),
    )
    print(f"compared {rep['common_samples']} samples")
    for k, n in rep["counts"].items():
        print(f"  {k:18s} {n}")
    if args.verbose:
        for d in rep["detail"]:
            print(f"  {d['id']}: {d['class']}  expected={d['expected']} "
                  f"batch={d['batch']} streaming={d['streaming']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
