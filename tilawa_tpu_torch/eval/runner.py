"""Experiment runner: evaluate a registered experiment over a corpus.

Port of tilawa_tpu/eval/runner.py (reference: benchmark/runner.py):
registry lookup, an uncounted warm-up, ordered-subsequence scoring,
predict()-vs-transcribe() dispatch, per-category filtering, a disposition
for every manifest sample (file_absent / undecodable / error), per-clip
latency with p50/p90 beside the mean, TILAWA_PROFILE stage rows, and a
timestamped results file plus a best-per-scope latest.json merge keyed
(name, mode, category, total, chunk_seconds).

The port writes its own results: results_torch/ at the repository root,
or TILAWA_TORCH_RESULTS_DIR; never benchmark/results/. Experiments run on
the card unless --device cpu is passed.

  python -m tilawa_tpu_torch.eval.runner --experiment c2c-direct-mixed-tta
  python -m tilawa_tpu_torch.eval.runner --experiment oracle --device cpu --no-save
"""

from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime
from pathlib import Path

from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat
from tilawa_tpu_torch.eval.metrics import best_emission_score, predict_to_emissions

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent

# v2 and v3 are not in the repository; point TILAWA_CORPUS_V2/V3 at them.
CORPUS_DIRS = {
    "v1": Path(os.getenv("TILAWA_CORPUS_V1", str(_REPO_ROOT / "benchmark" / "test_corpus"))),
    "v2": Path(os.getenv("TILAWA_CORPUS_V2", str(_REPO_ROOT / "benchmark" / "test_corpus_v2"))),
    "v3": Path(os.getenv("TILAWA_CORPUS_V3", str(_REPO_ROOT / "benchmark" / "test_corpus_v3"))),
}
RESULTS_DIR = Path(os.getenv("TILAWA_TORCH_RESULTS_DIR", str(_REPO_ROOT / "results_torch")))


def load_manifest(corpus: str = "v1") -> tuple[list[dict], Path]:
    corpus_dir = CORPUS_DIRS[corpus]
    with open(corpus_dir / "manifest.json", encoding="utf-8") as f:
        data = json.load(f)
    samples = data["samples"] if isinstance(data, dict) else data
    return samples, corpus_dir


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return vals[idx]


def run_experiment(
    name: str,
    pipeline,
    samples: list[dict],
    corpus_dir: Path,
    mode: str = "full",
    chunk_seconds: float = 3.0,
    streaming_pipeline=None,
) -> dict:
    """Evaluate one experiment object over the sample set.

    `pipeline` exposes predict(path) and/or transcribe(path); predict wins
    (reference dispatch: runner.py:250-268). In streaming mode without
    predict, transcribe() chunks feed the StreamingPipeline.
    """
    use_predict = hasattr(pipeline, "predict")
    if not use_predict and not hasattr(pipeline, "transcribe"):
        raise ValueError(f"{name}: no predict() or transcribe()")

    # Warm-up (uncounted — reference: runner.py:271-280).
    for sample in samples:
        path = corpus_dir / sample["file"]
        if not path.exists():
            continue
        try:
            if use_predict:
                pipeline.predict(str(path))
            else:
                pipeline.transcribe(str(path))
            break
        except UnsupportedAudioFormat:
            continue
        except Exception as e:  # noqa: BLE001 — reported; the scored loop records errors
            print(f"  warmup failed for {name}: {e}")
            break

    size = pipeline.model_size() if hasattr(pipeline, "model_size") else 0

    totals = {"recall": 0.0, "precision": 0.0, "sequence_accuracy": 0.0}
    latencies: list[float] = []
    per_sample: list[dict] = []
    # Every manifest sample gets an explicit disposition so "N of M scored"
    # is auditable (the reference scores all 53 v1 samples, runner.py:97-101;
    # 9 v1 audio files are absent from the repository's corpus).
    dispositions: list[dict] = []
    skipped = 0

    for sample in samples:
        path = corpus_dir / sample["file"]
        if not path.exists():
            skipped += 1
            dispositions.append(
                {"id": sample["id"], "status": "file_absent", "file": sample["file"]}
            )
            continue
        expected = sample.get(
            "expected_verses", [{"surah": sample["surah"], "ayah": sample["ayah"]}]
        )
        try:
            start = time.perf_counter()
            if use_predict:
                emissions = predict_to_emissions(pipeline.predict(str(path)))
            elif mode == "streaming":
                emissions = streaming_pipeline.run_on_audio_chunked(
                    str(path), pipeline.transcribe, chunk_seconds=chunk_seconds
                )
            else:
                emissions = streaming_pipeline.run_on_full_transcript(
                    str(path), pipeline.transcribe
                )
            elapsed = time.perf_counter() - start
        except UnsupportedAudioFormat as e:
            skipped += 1
            dispositions.append(
                {"id": sample["id"], "status": "undecodable", "file": sample["file"],
                 "why": str(e)}
            )
            continue
        except Exception as e:  # noqa: BLE001 — scored as a miss with its disposition
            print(f"  error on {sample['id']}: {e}")
            emissions, elapsed = [], 0.0
            dispositions.append({"id": sample["id"], "status": "error", "why": str(e)})

        scores = best_emission_score(expected, emissions, sample.get("also_accept"))
        for k in totals:
            totals[k] += scores[k]
        latencies.append(elapsed)
        row = {
            "id": sample["id"],
            "expected": expected,
            "predicted": emissions,
            **scores,
            "latency": elapsed,
        }
        # Per-stage wall times when TILAWA_PROFILE=1 (reference convention:
        # C2C_DIRECT_MIXED_PROFILE stage timers, c2c-direct-mixed/run.py:34).
        prof = getattr(pipeline, "last_profile", None)
        if prof:
            row["profile"] = {k: round(v, 4) for k, v in prof.items()}
        per_sample.append(row)

    n = len(per_sample)
    label = name if mode == "full" else f"{name} (stream {chunk_seconds:.0f}s)"
    return {
        "name": label,
        "recall": totals["recall"] / n if n else 0.0,
        "precision": totals["precision"] / n if n else 0.0,
        "sequence_accuracy": totals["sequence_accuracy"] / n if n else 0.0,
        "total": n,
        "total_manifest": len(samples),
        "skipped": skipped,
        "dispositions": dispositions,
        "avg_latency": sum(latencies) / n if n else 0.0,
        "p50_latency": _percentile(latencies, 0.5),
        "p90_latency": _percentile(latencies, 0.9),
        "model_size": size,
        # Rows from synthetic acoustic backends stay distinguishable from
        # real-model rows in every artifact.
        "acoustics": getattr(pipeline, "acoustics", "real"),
        "per_sample": per_sample,
    }


def save_results(
    results: list[dict],
    *,
    mode: str = "full",
    category: str | None = None,
    chunk_seconds: float = 3.0,
) -> Path:
    """Timestamped artifact + best-per-scope latest.json merge in
    RESULTS_DIR (reference: runner.py:386-469; better seq-acc wins,
    latency breaks ties)."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    timestamp = datetime.now().strftime("%Y-%m-%d_%H%M%S")
    path = RESULTS_DIR / f"{timestamp}.json"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, default=str)

    latest_path = RESULTS_DIR / "latest.json"
    latest: dict[tuple, dict] = {}
    if latest_path.exists():
        with open(latest_path, encoding="utf-8") as f:
            for entry in json.load(f):
                key = (
                    entry.get("name"), entry.get("mode", "full"),
                    entry.get("category"), entry.get("total"),
                    entry.get("chunk_seconds"),
                )
                latest[key] = entry

    for r in results:
        summary = {
            k: r[k]
            for k in (
                "name", "recall", "precision", "sequence_accuracy", "total",
                "total_manifest", "avg_latency", "p50_latency", "p90_latency",
                "model_size", "acoustics", "viterbi_sequence_accuracy",
                "exact_set_accuracy", "audio_sec_per_sec", "cycle_p50",
                "cycle_p90", "decode_cycle_p50", "decode_cycle_p90",
                "realtime_ok",
            )
            if k in r
        }
        summary.update(
            timestamp=timestamp,
            mode=mode,
            category=category,
            chunk_seconds=chunk_seconds if mode == "streaming" else None,
            source_file=path.name,
        )
        key = (
            summary["name"], summary["mode"], summary["category"],
            summary["total"], summary["chunk_seconds"],
        )
        prev = latest.get(key)
        if (
            prev is None
            or r["sequence_accuracy"] > prev.get("sequence_accuracy", 0)
            or (
                r["sequence_accuracy"] == prev.get("sequence_accuracy", 0)
                and r["avg_latency"] < prev.get("avg_latency", float("inf"))
            )
        ):
            latest[key] = summary

    # Once an experiment has a real-acoustics row, its synthetic-acoustics
    # rows (any scope) are superseded. Experiments that are oracle by
    # design (oracle / oracle-hard) have no real row and are untouched.
    real_names = {
        (e.get("name"), e.get("mode", "full"))
        for e in latest.values() if e.get("acoustics") == "real"
    }
    latest = {
        k: e for k, e in latest.items()
        if not (
            e.get("acoustics") == "oracle"
            and (e.get("name"), e.get("mode", "full")) in real_names
        )
    }

    with open(latest_path, "w", encoding="utf-8") as f:
        json.dump(
            sorted(
                latest.values(),
                key=lambda x: (
                    x.get("name", ""), x.get("mode", "full"),
                    x.get("category") or "", x.get("total", 0),
                    x.get("chunk_seconds") or 0,
                ),
            ),
            f, indent=2, default=str,
        )
    return path


def print_table(results: list[dict]) -> None:
    print()
    print(
        f"{'Experiment':<34} {'Recall':>7} {'Prec':>7} {'SeqAcc':>7} "
        f"{'Mean':>8} {'p50':>8} {'N':>4}"
    )
    print("-" * 80)
    for r in results:
        print(
            f"{r['name']:<34} {r['recall']:>6.0%} {r['precision']:>6.0%} "
            f"{r['sequence_accuracy']:>6.0%} {r['avg_latency']:>7.2f}s "
            f"{r['p50_latency']:>7.2f}s {r['total']:>4}"
        )
    print()


def main(argv=None):
    from tilawa_tpu_torch.eval.experiments import get_experiment, list_experiments

    parser = argparse.ArgumentParser(description="tilawa-tpu (PyTorch port) experiment runner")
    parser.add_argument("--experiment", default="c2c-direct-mixed-tta")
    parser.add_argument("--corpus", default="v1", choices=list(CORPUS_DIRS))
    parser.add_argument("--category", default=None)
    parser.add_argument("--mode", default="full", choices=["full", "streaming"])
    parser.add_argument("--chunk", type=float, default=3.0)
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--model", default=None,
                        help="variant for experiments with list_models() "
                             "(reference: runner.py:162-190 expansion)")
    parser.add_argument("--no-save", action="store_true",
                        help="diagnostic run: write no results file")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain ops)")
    args = parser.parse_args(argv)

    if args.list:
        # Multi-variant experiments print one line per list_models() entry
        # (reference: runner.py:162-190); pruned-ctc builds no model for it.
        for name in list_experiments():
            exp = get_experiment(name, device=args.device) if name == "pruned-ctc" else None
            if exp is not None and hasattr(exp, "list_models"):
                for m in exp.list_models():
                    print(f"{name}/{m}")
            else:
                print(name)
        return

    samples, corpus_dir = load_manifest(args.corpus)
    if args.category:
        samples = [s for s in samples if s["category"] == args.category]

    pipeline = get_experiment(args.experiment, device=args.device)
    if args.model is not None:
        if not hasattr(pipeline, "set_model"):
            raise SystemExit(f"{args.experiment} has no model variants")
        pipeline.set_model(args.model)
    streaming_pipeline = None
    if not hasattr(pipeline, "predict") or args.mode == "streaming":
        from tilawa_tpu_torch.streaming.pipeline import StreamingPipeline

        streaming_pipeline = StreamingPipeline()

    result = run_experiment(
        args.experiment, pipeline, samples, corpus_dir,
        mode=args.mode, chunk_seconds=args.chunk,
        streaming_pipeline=streaming_pipeline,
    )
    print_table([result])
    if args.no_save:
        print("results NOT saved (--no-save)")
    else:
        out = save_results(
            [result], mode=args.mode, category=args.category,
            chunk_seconds=args.chunk,
        )
        print(f"results saved to {out}")


if __name__ == "__main__":
    main()
