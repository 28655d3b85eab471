"""N-repeat stability report.

The reference needed this because ONNX inference jitters ±3-6 samples per
run, so it classifies each sample stable-pass / flaky / stable-fail over N
repeats and reports 3-run medians (reference:
web/frontend/test/stability-report.ts, EXPERIMENTS.md:9,283). XLA
compiles deterministically, so on tilawa-tpu the same report doubles as a
**determinism regression check**: any flaky sample is a bug, not noise
(SURVEY.md §5.2). On the card the port's kernels and its per-row
attention products make a forward bitwise repeatable, so the same holds.

Port of tilawa_tpu/eval/stability.py. Reports go to the port's results
directory (results_torch/, or TILAWA_TORCH_RESULTS_DIR), never under
benchmark/.

Usage (on the card; --device cpu for the plain ops):
  python -m tilawa_tpu_torch.eval.stability --experiment oracle --repeats 3
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from tilawa_tpu_torch.eval.metrics import predict_to_emissions, score_sequence
from tilawa_tpu_torch.eval.runner import CORPUS_DIRS, RESULTS_DIR, load_manifest


def classify(passes: list[bool]) -> str:
    if all(passes):
        return "stable_pass"
    if not any(passes):
        return "stable_fail"
    return "flaky"


def run_stability(
    experiment: str,
    corpus: str = "v1",
    category: str | None = None,
    repeats: int = 3,
    device: str = "cuda",
    ids: set[str] | None = None,
) -> dict:
    """Each sample `repeats` times through the experiment on `device` (the
    samples whose id is in `ids`, if given)."""
    from tilawa_tpu_torch.eval.experiments import get_experiment

    samples, corpus_dir = load_manifest(corpus)
    if category:
        samples = [s for s in samples if s["category"] == category]
    if ids is not None:
        samples = [s for s in samples if s["id"] in ids]
    pipeline = get_experiment(experiment, device=device)

    per_sample: dict[str, list[bool]] = {}
    run_seq_accs: list[float] = []
    for _ in range(repeats):
        seq_acc_total, n = 0.0, 0
        for s in samples:
            path = corpus_dir / s["file"]
            if not path.exists():
                continue
            expected = s.get(
                "expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}]
            )
            try:
                result = pipeline.predict(str(path))
                got = predict_to_emissions(result)
            except Exception:  # noqa: BLE001 — a raising sample scores as a miss, as in JAX
                got = []
            sc = score_sequence(expected, got)
            ok = sc["sequence_accuracy"] >= 0.999
            per_sample.setdefault(s["id"], []).append(ok)
            seq_acc_total += sc["sequence_accuracy"]
            n += 1
        run_seq_accs.append(seq_acc_total / n if n else 0.0)

    classes = {sid: classify(passes) for sid, passes in per_sample.items()}
    counts = {"stable_pass": 0, "flaky": 0, "stable_fail": 0}
    for c in classes.values():
        counts[c] += 1
    run_seq_accs.sort()
    report = {
        "experiment": experiment,
        "corpus": corpus,
        "category": category,
        "repeats": repeats,
        "samples": len(per_sample),
        **counts,
        "deterministic": counts["flaky"] == 0,
        "median_seq_acc": run_seq_accs[len(run_seq_accs) // 2]
        if run_seq_accs else 0.0,
        "per_sample": classes,
    }
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description="N-repeat stability report")
    parser.add_argument("--experiment", default="oracle")
    parser.add_argument("--corpus", default="v1", choices=list(CORPUS_DIRS))
    parser.add_argument("--category", default=None)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain ops)")
    args = parser.parse_args(argv)
    report = run_stability(
        args.experiment, args.corpus, args.category, args.repeats, args.device
    )
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = RESULTS_DIR / f"stability_{args.experiment}_{int(time.time())}.json"
    out.write_text(json.dumps(report, indent=2), encoding="utf-8")
    summary = {k: v for k, v in report.items() if k != "per_sample"}
    print(json.dumps(summary, indent=2))
    print(f"full report: {out}")
    return 0 if report["deterministic"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
