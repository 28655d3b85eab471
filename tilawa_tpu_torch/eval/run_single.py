"""Per-experiment persistent results (reference: benchmark/run_single.py:
keeps one evolving JSON per experiment under benchmark/experiment_results/
so an experiment's history survives `latest.json` best-per-scope merges).

Port of tilawa_tpu/eval/run_single.py: the history goes to
experiment_results/ in the port's results directory (results_torch/, or
TILAWA_TORCH_RESULTS_DIR), never under benchmark/.

Usage (on the card; --device cpu for the plain ops):
  python -m tilawa_tpu_torch.eval.run_single --experiment oracle --corpus v1
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from tilawa_tpu_torch.eval.runner import (
    CORPUS_DIRS,
    RESULTS_DIR,
    load_manifest,
    print_table,
    run_experiment,
)

EXPERIMENT_RESULTS_DIR = RESULTS_DIR / "experiment_results"


def run_single(
    experiment: str,
    corpus: str = "v1",
    category: str | None = None,
    mode: str = "full",
    chunk_seconds: float = 3.0,
    device: str = "cuda",
) -> dict:
    from tilawa_tpu_torch.eval.experiments import get_experiment

    samples, corpus_dir = load_manifest(corpus)
    if category:
        samples = [s for s in samples if s["category"] == category]
    pipeline = get_experiment(experiment, device=device)
    streaming_pipeline = None
    if not hasattr(pipeline, "predict") or mode == "streaming":
        from tilawa_tpu_torch.streaming.pipeline import StreamingPipeline

        streaming_pipeline = StreamingPipeline()
    result = run_experiment(
        experiment, pipeline, samples, corpus_dir,
        mode=mode, chunk_seconds=chunk_seconds,
        streaming_pipeline=streaming_pipeline,
    )
    save_single(experiment, result, corpus=corpus, category=category, mode=mode)
    return result


def save_single(
    experiment: str, result: dict, corpus: str, category: str | None, mode: str
) -> Path:
    EXPERIMENT_RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = EXPERIMENT_RESULTS_DIR / f"{experiment}.json"
    history = []
    if path.exists():
        try:
            history = json.loads(path.read_text(encoding="utf-8"))
        except json.JSONDecodeError:
            history = []
    history.append(
        {
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            "corpus": corpus,
            "category": category,
            "mode": mode,
            **{
                k: result[k]
                for k in (
                    "recall", "precision", "sequence_accuracy",
                    "avg_latency", "p50_latency", "total",
                )
                if k in result
            },
        }
    )
    path.write_text(json.dumps(history, indent=2), encoding="utf-8")
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description="single-experiment runner")
    parser.add_argument("--experiment", required=True)
    parser.add_argument("--corpus", default="v1", choices=list(CORPUS_DIRS))
    parser.add_argument("--category", default=None)
    parser.add_argument("--mode", default="full", choices=["full", "streaming"])
    parser.add_argument("--chunk", type=float, default=3.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain ops)")
    args = parser.parse_args(argv)
    result = run_single(
        args.experiment, args.corpus, args.category, args.mode, args.chunk,
        args.device,
    )
    print_table([result])
    print(f"history appended to {EXPERIMENT_RESULTS_DIR / (args.experiment + '.json')}")


if __name__ == "__main__":
    main()
