"""The port's headline benchmark: the champion over the v1 corpus on the card.

    python -m tilawa_tpu_torch.bench                 # one CUDA card
    python -m tilawa_tpu_torch.bench --device cpu    # plain ops, slow

Port of the repository's bench.py on the PyTorch runtime. It runs the
champion pipeline (c2c-direct-mixed-tta: int4 FastConformer forward with
the hand kernels, greedy decode, retrieval, CTC rerank on the device,
gated TTA) over every decodable v1 clip and prints ONE JSON line with the
same keys as bench.py: p50 per-clip latency (`value`), mean and p90,
sequential and batched audio-s/s, recall and sequence accuracy of both
passes, the batched pass's stage times, model bytes, clip counts,
`partial`, and the MFU of both passes against the H100 SXM's dense bf16
rate (989 TF/s, NVIDIA H100 data sheet). Every line carries the card's
name (`device`) and power limit (`power_limit_w`, from nvidia-smi).

Schedule: device init (a timed torch.cuda.init and one tiny kernel,
`device_init_s`) → checkpoint (int4-packed at load if the bundle is not
int4) → warm every shape the timed loop can hit → the batched corpus eval
→ the per-clip timed loop. A deadline (BENCH_BUDGET_S, default 420 s from the start)
is checked between stages and clips; SIGTERM and SIGINT print the line with
an `error`; a budget-cut run says `"partial": true`. Progress goes to
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Reference comparators (the reference's ONNX pipeline on a CPU, not a
# TPU): mean 0.84 s per clip, easy-sample median ~0.25 s
# (experiments/c2c-direct-mixed-tta/run.py:22-26).
REF_MEAN_S = 0.84
REF_MEDIAN_S = 0.25
H100_BF16_PEAK_FLOPS = 989e12


class Budget:
    """The run's deadline (BENCH_BUDGET_S seconds from its start, default
    420) and its stderr progress log."""

    def __init__(self, seconds: float | None = None):
        self.seconds = float(os.getenv("BENCH_BUDGET_S", "420")) if seconds is None else seconds
        self.t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def left(self) -> float:
        return self.seconds - self.elapsed()

    def log(self, msg: str) -> None:
        print(f"[bench +{self.elapsed():6.1f}s] {msg}", file=sys.stderr, flush=True)


def new_line() -> dict:
    return {
        "metric": "p50_latency_s_per_clip_v1",
        "value": None,
        "unit": "s",
        "vs_baseline": None,
        "baseline": {"ref_mean_s": REF_MEAN_S, "ref_median_easy_s": REF_MEDIAN_S},
        "partial": True,
    }


def emit(out: dict) -> None:
    print(json.dumps(out), flush=True)


def power_limit_w() -> float | None:
    """The card's power limit as nvidia-smi reports it (None without one)."""
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return float(text.strip().splitlines()[0])


def init_device(device: str, out: dict) -> torch.device:
    """Resolve the device, pay its first-use cost and time it."""
    from tilawa_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    t = time.monotonic()
    if dev.type == "cuda":
        torch.cuda.init()
    float(torch.ones(8, device=dev).sum())
    out["device_init_s"] = round(time.monotonic() - t, 3)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    out["power_limit_w"] = power_limit_w() if dev.type == "cuda" else None
    return dev


def load(device: torch.device, out: dict):
    """The champion Recognizer(tta=True) on `device`: the shipped
    checkpoint, int4-packed at load if it is not int4."""
    from tilawa_tpu_torch.eval.experiments import load_shipped
    from tilawa_tpu_torch.pipeline.predict import Recognizer
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime

    config, variables, weights = load_shipped("int4")
    recognizer = Recognizer(EncoderRuntime(config, variables, device=device), tta=True)
    out["weights"] = weights
    out["model_size_bytes"] = recognizer.model_size()
    return recognizer


def load_clips(out: dict, ids: set[str] | None = None):
    """(id, waveform, expected, also_accept) of every decodable v1 clip
    (or of `ids`), shortest first, so a budget cut keeps the cheap buckets."""
    from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
    from tilawa_tpu_torch.eval.runner import load_manifest

    samples, corpus_dir = load_manifest("v1")
    if ids is not None:
        samples = [s for s in samples if s["id"] in ids]
    audios, skipped = [], 0
    for s in samples:
        path = corpus_dir / s["file"]
        if not path.exists():
            skipped += 1
            continue
        try:
            audio = load_audio(path)
        except UnsupportedAudioFormat:
            skipped += 1
            continue
        expected = s.get("expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}])
        audios.append((s["id"], audio, expected, s.get("also_accept")))
    out["n_total_manifest"] = len(samples)
    out["n_skipped_undecodable_or_absent"] = skipped
    audios.sort(key=lambda x: len(x[1]))
    return audios


def warm(recognizer, audios, budget: Budget) -> None:
    """Run once, uncounted, every shape the timed loop can hit: the
    [1, bucket] forwards (with a predict, so retrieval is warm too), the
    [K, 256000] stitched forwards of long chunking, the [2, bucket] TTA
    pair, and the rerank lattice. Eager torch compiles nothing; the first
    call of a shape pays the allocator's growth and cuDNN's algorithm
    choice."""
    from tilawa_tpu_torch.pipeline.rerank import score_token_lists
    from tilawa_tpu_torch.pipeline.runtime import LONG_THRESHOLD, bucket_length

    runtime = recognizer.runtime
    shapes: list[tuple[str, str, int]] = []
    seen_buckets: set[int] = set()
    seen_k: set[int] = set()
    tta_bucket = 0
    for _sid, audio, _exp, _alt in audios:
        n = len(audio)
        if runtime.long_chunking and n > LONG_THRESHOLD:
            k = runtime.chunk_count(n)
            if k not in seen_k:
                seen_k.add(k)
                shapes.append((f"long k={k}", "long", n))
        else:
            b = bucket_length(n)
            if b not in seen_buckets:
                seen_buckets.add(b)
                shapes.append((f"bucket {b}", "single", b))
            if n <= LONG_THRESHOLD:
                # the TTA pair buckets by its longer variant; n / 0.9 covers
                # both (variant_length: 1.1x gives ceil(n * 11 / 10) samples)
                tta_bucket = max(tta_bucket, bucket_length(int(n / 0.9) + 1))
    if tta_bucket:
        shapes.append((f"tta [2, {tta_bucket}]", "tta", tta_bucket))
    for label, kind, n in shapes:
        if budget.left() < 30:
            budget.log(f"budget: skipping warm-up of {label}+")
            return
        t = time.monotonic()
        if kind == "single":
            recognizer.predict_audio(np.zeros(n, dtype=np.float32))
        elif kind == "long":
            runtime.forward_long(np.zeros(n, dtype=np.float32))
        else:
            runtime.forward_batch([np.zeros(n, np.float32), np.zeros(n - 1, np.float32)])
        budget.log(f"warm {label}: {time.monotonic() - t:.1f}s")
    if budget.left() > 20:
        t = time.monotonic()
        lp = torch.zeros((512, runtime.config.num_classes), device=runtime.device)
        score_token_lists(lp, 400, [[1, 2, 3]] * 64, blank_id=runtime.blank_id)
        budget.log(f"warm rerank lattice: {time.monotonic() - t:.1f}s")


def batched(recognizer, audios, out: dict, budget: Budget) -> None:
    """The batched corpus eval (TTA included) and its end-to-end MFU."""
    from tilawa_tpu_torch.eval.batched import batched_corpus_eval
    from tilawa_tpu_torch.models.fastconformer import forward_flops

    if budget.left() <= 60:
        budget.log("skipping batched eval (budget)")
        return
    budget.log("batched corpus eval")
    config = recognizer.runtime.config
    # per-clip FLOPs: the T^2 attention term takes each clip's own length
    corpus_flops = sum(forward_flops(config, len(a) / 16000.0) for _s, a, _e, _alt in audios)
    try:
        res = batched_corpus_eval(
            recognizer, [(sid, a, e) for sid, a, e, _alt in audios],
            batch_size=int(os.getenv("TILAWA_BATCHED_BS", "8")),
        )
    except Exception as e:  # noqa: BLE001 — recorded in the line; the timed loop still runs
        budget.log(f"batched eval failed: {e}")
        out["batched_error"] = f"{type(e).__name__}: {e}"
        return
    out["audio_sec_per_sec_batched"] = res["audio_sec_per_sec"]
    out["batched_recall"] = res["recall"]
    out["batched_seq_acc"] = res["seq_acc"]
    out["batched_tta_clips"] = res["n_tta"]
    if res["wall_s"]:
        # forwards overlap the host stack, so this is end to end (host
        # decision-stack time included)
        out["mfu_batched_e2e"] = round(corpus_flops / res["wall_s"] / H100_BF16_PEAK_FLOPS, 5)
        for key in ("fetch_wait_s", "decode_s", "predict_s", "wall_s"):
            out[f"batched_{key}"] = res[key]


def timed_loop(recognizer, audios, out: dict, budget: Budget) -> None:
    """predict_audio per clip on the host clock (each ends in host reads
    of the device's results), scored against the manifest."""
    from tilawa_tpu_torch.eval.metrics import best_emission_score, predict_to_emissions
    from tilawa_tpu_torch.models.fastconformer import forward_flops

    latencies: list[float] = []
    total_audio_s = 0.0
    scores = {"recall": 0.0, "precision": 0.0, "sequence_accuracy": 0.0}
    for _sid, audio, expected, also_accept in audios:
        if budget.left() < 10:
            budget.log(f"budget: stopping timed loop after {len(latencies)} clips")
            break
        t0 = time.perf_counter()
        result = recognizer.predict_audio(audio)
        latencies.append(time.perf_counter() - t0)
        total_audio_s += len(audio) / 16000.0
        s = best_emission_score(expected, predict_to_emissions(result), also_accept)
        for k in scores:
            scores[k] += s[k]
    budget.log(f"timed loop: {len(latencies)} clips in {sum(latencies):.1f}s")

    n = len(latencies)
    if not n:
        return
    lat = sorted(latencies)
    wall = sum(latencies)
    p50 = lat[n // 2]
    out["value"] = round(p50, 4)
    out["vs_baseline"] = round(p50 / REF_MEDIAN_S, 4)
    out["mean_latency_s"] = round(wall / n, 4)
    out["vs_baseline_mean"] = round(wall / n / REF_MEAN_S, 4)
    out["p90_latency_s"] = round(lat[int(0.9 * (n - 1))], 4)
    out["audio_sec_per_sec"] = round(total_audio_s / wall, 2) if wall else None
    out["partial"] = n < len(audios)
    # MFU only on a full run: the FLOPs cover every clip
    if not out["partial"] and wall:
        corpus_flops = sum(
            forward_flops(recognizer.runtime.config, len(a) / 16000.0) for _s, a, _e, _alt in audios
        )
        out["mfu_sequential"] = round(corpus_flops / wall / H100_BF16_PEAK_FLOPS, 5)
    out["n_clips"] = n
    out["recall"] = round(scores["recall"] / n, 4)
    out["seq_acc"] = round(scores["sequence_accuracy"] / n, 4)


def run(out: dict, budget: Budget, device: str = "cuda", ids: set[str] | None = None) -> None:
    """The whole schedule into `out` (the v1 clips, or only `ids`)."""
    budget.log(f"budget {budget.seconds:.0f}s; initializing {device}")
    dev = init_device(device, out)
    budget.log(f"{out['device']} ready in {out['device_init_s']}s; loading checkpoint")
    recognizer = load(dev, out)
    budget.log(f"checkpoint ready ({out['weights']})")
    audios = load_clips(out, ids)
    budget.log(f"{len(audios)} clips decodable ({out['n_skipped_undecodable_or_absent']} "
         f"absent/undecodable)")
    warm(recognizer, audios, budget)
    batched(recognizer, audios, out, budget)
    timed_loop(recognizer, audios, out, budget)


def main(argv=None) -> int:
    import signal

    parser = argparse.ArgumentParser(description="the port's headline benchmark")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain ops)")
    args = parser.parse_args(argv)
    out = new_line()
    budget = Budget()

    def on_term(signum, frame):  # noqa: ARG001 — signal handler signature
        out["error"] = f"killed by signal {signum} at +{budget.elapsed():.0f}s"
        emit(out)
        os._exit(124)

    previous = {sig: signal.signal(sig, on_term) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        run(out, budget, args.device)
    except Exception as e:  # noqa: BLE001 — the JSON line must survive any failure
        out["error"] = f"{type(e).__name__}: {e}"
        import traceback

        traceback.print_exc()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    emit(out)
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main())
