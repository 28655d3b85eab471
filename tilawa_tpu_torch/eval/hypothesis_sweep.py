"""Offline HypothesisParams sweep over dumped Viterbi inputs.

finalize() is a pure function of (cycles, committed, params), so the
expensive part of tuning the final-sequence Viterbi — replaying every
corpus clip through the tracker — only has to happen once per corpus:

  TILAWA_DUMP_HYPOTHESIS=1 \
      python -m tilawa_tpu_torch.eval.tracker_oracle --corpus v1 --out v1.json

then sweeps re-score in milliseconds:

  python -m tilawa_tpu_torch.eval.hypothesis_sweep v1.json v2.json \
      --param skip_scale --values 0.6,0.8,1.0,1.2

(reference analogue: STREAMING_HYPOTHESIS_* env overrides on tracker.ts
Viterbi constants, tracker.ts:453-481 — tuned there by full re-runs.)

Known limitation: a clip with a mid-clip silence flush spans multiple
utterances, and only the LAST non-empty utterance's hypothesis survives
in the dump — such clips under-score every config equally. Treat sweep
results as comparative, and confirm any default change with a LIVE
oracle re-run (round-3 live runs scored slightly ABOVE the offline
estimates: 0.886/0.907/0.847 vs 0.88/0.88/0.86).

A copy of tilawa_tpu/eval/hypothesis_sweep.py; it reads the dumps the
port's validate_streaming and tracker_oracle write under
TILAWA_DUMP_HYPOTHESIS.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json

from tilawa_tpu_torch.eval.metrics import score_sequence
from tilawa_tpu_torch.streaming.config import HypothesisParams
from tilawa_tpu_torch.streaming.tracker import StreamingHypothesis


def _also_accept_by_id() -> dict[str, list]:
    from tilawa_tpu_torch.eval.runner import CORPUS_DIRS

    out: dict[str, list] = {}
    for key in ("v1", "v2", "v3"):
        mpath = CORPUS_DIRS[key] / "manifest.json"
        if not mpath.exists():
            continue
        with open(mpath, encoding="utf-8") as f:
            data = json.load(f)
        for s in data["samples"] if isinstance(data, dict) else data:
            if s.get("also_accept"):
                out[s["id"]] = s["also_accept"]
    return out


def load_dumps(paths: list[str]) -> list[dict]:
    alts = _also_accept_by_id()
    rows = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if isinstance(data, list):
            # validate_streaming save_results artifact: a list of result
            # rows, each carrying its own per_sample
            entries = [e for d in data for e in d.get("per_sample", [])]
        else:
            entries = data.get("per_sample", [])
        for s in entries:
            if "hypothesis" in s:
                if not (
                    s["hypothesis"].get("cycles")
                    or s["hypothesis"].get("committed")
                ):
                    # trailing-silence re-flush clobbered the snapshot in
                    # older dumps — constant zero for every config, skip
                    continue
                rows.append(
                    {
                        "id": s["id"],
                        "corpus": path,
                        "expected": s["expected"],
                        "also_accept": alts.get(s["id"]),
                        **s["hypothesis"],
                    }
                )
    return rows


def score_params(rows: list[dict], params: HypothesisParams) -> dict:
    total = 0.0
    n = 0
    per_corpus: dict[str, list[float]] = {}
    for r in rows:
        h = StreamingHypothesis(params)
        h.cycles = [list(c) for c in r["cycles"]]
        h.committed = list(r["committed"])
        out = h.finalize()
        verses = out["verses"] if out else []
        from tilawa_tpu_torch.eval.metrics import best_emission_score

        s = best_emission_score(
            r["expected"], verses, r.get("also_accept")
        )["sequence_accuracy"]
        total += s
        n += 1
        per_corpus.setdefault(r["corpus"], []).append(s)
    return {
        "mean_seq_acc": total / n if n else 0.0,
        "n": n,
        "per_corpus": {
            k: round(sum(v) / len(v), 4) for k, v in per_corpus.items()
        },
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="offline Viterbi param sweep")
    parser.add_argument("dumps", nargs="+", help="per-sample JSONs with hypothesis dumps")
    parser.add_argument("--param", action="append", default=[],
                        help="param name to sweep (repeatable)")
    parser.add_argument("--values", action="append", default=[],
                        help="comma-separated values, one per --param")
    args = parser.parse_args(argv)

    rows = load_dumps(args.dumps)
    if not rows:
        print("no hypothesis dumps found (set TILAWA_DUMP_HYPOTHESIS=1)")
        return 1
    print(f"{len(rows)} dumped samples from {len(args.dumps)} file(s)")

    base = HypothesisParams()
    print(f"base: {score_params(rows, base)}")
    if not args.param:
        return 0

    grids = [
        [float(v) for v in vals.split(",")] for vals in args.values
    ]
    best = None
    for combo in itertools.product(*grids):
        params = dataclasses.replace(
            base, **dict(zip(args.param, combo))
        )
        result = score_params(rows, params)
        label = ", ".join(
            f"{p}={v}" for p, v in zip(args.param, combo)
        )
        print(f"{label}: {result}")
        if best is None or result["mean_seq_acc"] > best[1]["mean_seq_acc"]:
            best = (label, result)
    print(f"BEST: {best[0]} -> {best[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
