"""Browser-parity streaming validation on the PyTorch runtime: replay
corpus audio through the full RecitationTracker and score the emitted verse
sequence (port of tilawa_tpu/eval/validate_streaming.py).

This is the tilawa-tpu equivalent of the reference's node harness that
imports the actual browser source and replays corpus clips at 300 ms
chunks plus a 4 s synthetic silence tail so the final-flush path fires
(reference: web/frontend/test/validate-streaming.ts:15-31,
validate-streaming-matrix.ts — the chunk-size sweep). Unlike the WS
endpoint bench (eval/ws_bench.py), this drives the tracker in-process:
no transport, deterministic, and the per-sample wall time measures the
real compute cost of the streaming brain.

Scoring matches the batch runner (ordered-subsequence score_sequence,
reference: benchmark/runner.py:104-143). The port prints its summary line
and writes no results file (benchmark/results/ belongs to the JAX runner).

Usage (on the card; --device cpu for the plain ops):
  python -m tilawa_tpu_torch.eval.validate_streaming --corpus v1 --chunk 0.3
  python -m tilawa_tpu_torch.eval.validate_streaming --checkpoint exports/stream6-int8
  python -m tilawa_tpu_torch.eval.validate_streaming --matrix 0.2,0.3,0.5
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.data.token_store import TokenStore
from tilawa_tpu_torch.eval.metrics import best_emission_score, exact_set_accuracy
from tilawa_tpu_torch.streaming.config import DEFAULT_STREAMING_CONFIG, STREAMING_PRESETS
from tilawa_tpu_torch.streaming.tracker import RecitationTracker

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
CORPUS_DIRS = {
    "v1": Path(os.getenv("TILAWA_CORPUS_V1", str(_REPO_ROOT / "benchmark" / "test_corpus"))),
}
SAMPLE_RATE = 16000
CHUNK_SECONDS = 0.3          # validate-streaming.ts chunk cadence
TAIL_SILENCE_SECONDS = 4.0   # TAIL_SILENCE_SECONDS, validate-streaming.ts:31


def load_manifest(corpus: str = "v1") -> tuple[list[dict], Path]:
    """(samples, corpus directory) of a corpus manifest
    (tilawa_tpu/eval/runner.py load_manifest)."""
    corpus_dir = CORPUS_DIRS[corpus]
    with open(corpus_dir / "manifest.json", encoding="utf-8") as f:
        data = json.load(f)
    samples = data["samples"] if isinstance(data, dict) else data
    return samples, corpus_dir


def _pct(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    return round(vals[min(len(vals) - 1, int(q * (len(vals) - 1)))], 4)


def replay_sample(
    tracker: RecitationTracker,
    audio: np.ndarray,
    chunk_seconds: float = CHUNK_SECONDS,
    tail_silence: float = TAIL_SILENCE_SECONDS,
    on_chunk=None,
    feed_times: list[float] | None = None,
) -> list[dict]:
    """Feed one clip chunk-by-chunk plus a silence tail; return every
    message the tracker emitted. `on_chunk(fed_samples)` fires before each
    feed so stateful fake transcribers (eval/tracker_oracle.py) can map the
    tracker's rolling window back to absolute clip time."""
    chunk = max(1, int(SAMPLE_RATE * chunk_seconds))
    padded = np.concatenate(
        [np.asarray(audio, np.float32),
         np.zeros(int(SAMPLE_RATE * tail_silence), np.float32)]
    )
    messages: list[dict] = []
    for i in range(0, len(padded), chunk):
        end = min(i + chunk, len(padded))
        if on_chunk is not None:
            on_chunk(end)
        t0 = time.perf_counter()
        messages.extend(tracker.feed(padded[i:end]))
        if feed_times is not None:
            feed_times.append(time.perf_counter() - t0)
    return messages


def emissions_from_messages(messages: list[dict]) -> list[dict]:
    """verse_match stream → ordered (surah, ayah) emissions, spans
    expanded, dedup-preserving-order (matches ws_bench scoring).
    verse_rollback retracts the matching verse_match's refs (the tracker's
    misidentification revert; reference: web/server.py:625-675)."""
    out: list[dict] = []
    seen: set[tuple[int, int]] = set()
    for m in messages:
        if m.get("type") == "verse_rollback":
            end = m.get("ayah_end") or m["ayah"]
            refs = {(m["surah"], a) for a in range(m["ayah"], end + 1)}
            out = [e for e in out if (e["surah"], e["ayah"]) not in refs]
            seen -= refs
            continue
        if m.get("type") != "verse_match":
            continue
        end = m.get("ayah_end") or m["ayah"]
        for a in range(m["ayah"], end + 1):
            if (m["surah"], a) not in seen:
                seen.add((m["surah"], a))
                out.append({"surah": m["surah"], "ayah": a})
    return out


def final_sequence_from_messages(messages: list[dict]) -> list[dict] | None:
    """The StreamingHypothesis final answer across the whole clip.

    finalize() runs per UTTERANCE (reference: tracker.ts per-flush
    Viterbi); a clip with a mid-clip silence flush emits several
    final_sequence messages. Scoring only the last one dropped every
    earlier utterance's verses (the hypothesis_sweep 'known limitation'),
    so concatenate them in order with in-order dedup — the same
    aggregation emissions get."""
    out: list[dict] = []
    seen: set[tuple[int, int]] = set()
    found = False
    for m in messages:
        if m.get("type") == "verse_rollback":
            # a retraction after the utterance's final_sequence was
            # emitted (superseded-commit rollback) must retract there too
            end = m.get("ayah_end") or m["ayah"]
            refs = {(m["surah"], a) for a in range(m["ayah"], end + 1)}
            out = [v for v in out if (v["surah"], v["ayah"]) not in refs]
            seen -= refs
            continue
        if m.get("type") != "final_sequence":
            continue
        found = True
        for v in m.get("verses", []):
            ref = (v["surah"], v["ayah"])
            if ref not in seen:
                seen.add(ref)
                out.append({"surah": v["surah"], "ayah": v["ayah"]})
    return out if found else None


def run_validation(
    transcribe,
    corpus: str = "v1",
    category: str | None = None,
    chunk_seconds: float = CHUNK_SECONDS,
    preset: str | None = None,
    limit: int | None = None,
    ids: set[str] | None = None,
    db: QuranDB | None = None,
    token_store: TokenStore | None = None,
    verbose: bool = True,
    transcribe_factory=None,
    name: str | None = None,
) -> dict:
    samples, corpus_dir = load_manifest(corpus)
    if category:
        samples = [s for s in samples if s.get("category") == category]
    if ids:
        samples = [s for s in samples if s["id"] in ids]
    if limit:
        samples = samples[:limit]

    db = db or QuranDB()
    token_store = token_store or TokenStore.load_default()
    config = STREAMING_PRESETS[preset] if preset else None

    totals = {"recall": 0.0, "precision": 0.0, "sequence_accuracy": 0.0}
    viterbi_totals = dict(totals)
    exact_set_total = 0.0
    latencies: list[float] = []
    feed_times: list[float] = []
    per_sample: list[dict] = []
    skipped = 0
    total_audio_s = 0.0

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
        expected = s.get(
            "expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}]
        )
        on_chunk = None
        sample_transcribe = transcribe
        if transcribe_factory is not None:
            made = transcribe_factory(s, audio)
            if made is None:
                skipped += 1
                continue
            sample_transcribe = made
            on_chunk = getattr(made, "on_chunk", None)
        tracker = RecitationTracker(
            sample_transcribe, db=db, token_store=token_store, config=config
        )
        t0 = time.perf_counter()
        messages = replay_sample(
            tracker, audio, chunk_seconds, on_chunk=on_chunk,
            feed_times=feed_times,
        )
        elapsed = time.perf_counter() - t0
        latencies.append(elapsed)
        total_audio_s += len(audio) / SAMPLE_RATE

        emissions = emissions_from_messages(messages)
        also = s.get("also_accept")
        scores = best_emission_score(expected, emissions, also)
        viterbi = final_sequence_from_messages(messages)
        v_scores = (
            best_emission_score(expected, viterbi, also) if viterbi else scores
        )
        for k in totals:
            totals[k] += scores[k]
            viterbi_totals[k] += v_scores[k]
        exact_set_total += exact_set_accuracy(expected, emissions)
        row = {
            "id": s["id"],
            "expected": expected,
            "predicted": emissions,
            "final_sequence": viterbi,
            **scores,
            "latency": elapsed,
        }
        if os.getenv("TILAWA_DUMP_HYPOTHESIS"):
            # Raw Viterbi inputs, for offline HypothesisParams sweeps
            # without re-running the tracker: finalize() is pure given
            # (cycles, committed).
            row["hypothesis"] = tracker.last_hypothesis_snapshot or {
                "cycles": tracker.hypothesis.cycles,
                "committed": tracker.hypothesis.committed,
            }
        per_sample.append(row)
        if verbose:
            got = [(e["surah"], e["ayah"]) for e in emissions]
            print(
                f"  {s['id']}: seq_acc={scores['sequence_accuracy']:.2f} "
                f"got={got} wall={elapsed:.2f}s"
            )

    n = len(per_sample)
    wall = sum(latencies)
    result = {
        "name": name or f"tracker-streaming{'-' + preset if preset else ''}",
        "recall": totals["recall"] / n if n else 0.0,
        "precision": totals["precision"] / n if n else 0.0,
        "sequence_accuracy": totals["sequence_accuracy"] / n if n else 0.0,
        "exact_set_accuracy": exact_set_total / n if n else 0.0,
        "viterbi_sequence_accuracy": viterbi_totals["sequence_accuracy"] / n
        if n else 0.0,
        "total": n,
        "skipped": skipped,
        "avg_latency": wall / n if n else 0.0,
        "p50_latency": sorted(latencies)[n // 2] if n else 0.0,
        "p90_latency": sorted(latencies)[int(0.9 * (n - 1))] if n else 0.0,
        "audio_sec_per_sec": total_audio_s / wall if wall else 0.0,
        # Real-time criterion: a feed cycle must finish inside the chunk
        # cadence (VERDICT r2 #4; reference cycles 0.25-2 s live windows,
        # tracker.ts:601). Decode cycles = feeds that actually hit the
        # acoustic backend (>5 ms); the rest are buffer appends.
        "cycle_p50": _pct(feed_times, 0.5),
        "cycle_p90": _pct(feed_times, 0.9),
        "decode_cycle_p50": _pct([t for t in feed_times if t > 0.005], 0.5),
        "decode_cycle_p90": _pct([t for t in feed_times if t > 0.005], 0.9),
        # Falsifiable real-time criterion (VERDICT r3 weak #1): the p90 of
        # ALL cycles against the chunk cadence flatters the system — most
        # cycles are <5 ms buffer appends. The cycles that can fall behind
        # are DECODE cycles, and they recur at the effective trigger
        # period, not the chunk cadence: tracking triggers every
        # tracking_trigger_sec (the tighter of the two modes), so the
        # tracker keeps up iff decode_cycle_p90 fits inside that period.
        "realtime_cadence_ok": bool(
            feed_times and _pct(feed_times, 0.9) < chunk_seconds
        ),
        "effective_trigger_period_s": (
            config or DEFAULT_STREAMING_CONFIG
        ).tracking_trigger_sec,
        "realtime_ok": bool(
            feed_times
            and _pct([t for t in feed_times if t > 0.005], 0.9)
            < (config or DEFAULT_STREAMING_CONFIG).tracking_trigger_sec
        ),
        "model_size": getattr(transcribe, "model_size_bytes", 0),
        # streaming evals always run real (or explicitly-named oracle)
        # acoustics; tracker_oracle overrides via `name`
        "acoustics": "oracle" if "oracle" in (name or "") else "real",
        "per_sample": per_sample,
    }
    return result


def _real_transcribe(device: str = "cuda", checkpoint: str | None = None):
    """The tracker's transcribe function: Recognizer.transcribe_result over
    the bundle at `checkpoint` (default: the shipped checkpoint) on
    `device`."""
    from tilawa_tpu_torch.eval.experiments import load_runtime
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    recognizer = Recognizer(load_runtime(checkpoint, device))

    def fn(audio):
        return recognizer.transcribe_result(audio)

    # carried into the results row (goal constraint <200 MB, README.md:198-208)
    fn.model_size_bytes = recognizer.model_size()
    return fn


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="tracker streaming validation (browser-parity harness)"
    )
    parser.add_argument("--corpus", default="v1")
    parser.add_argument("--category", default=None)
    parser.add_argument("--chunk", type=float, default=CHUNK_SECONDS)
    parser.add_argument(
        "--matrix", default=None,
        help="comma-separated chunk sizes to sweep (validate-streaming-matrix)",
    )
    parser.add_argument("--preset", default=None,
                        choices=[None, *STREAMING_PRESETS])
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--ids", default=None,
                        help="comma-separated sample ids to replay")
    parser.add_argument("--checkpoint", default=None,
                        help="bundle directory (default: the shipped checkpoint)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    transcribe = _real_transcribe(args.device, args.checkpoint)
    chunks = (
        [float(c) for c in args.matrix.split(",")] if args.matrix
        else [args.chunk]
    )
    db, store = QuranDB(), TokenStore.load_default()
    for chunk_s in chunks:
        print(f"== tracker streaming: corpus={args.corpus} chunk={chunk_s}s "
              f"preset={args.preset or 'default'} ==")
        result = run_validation(
            transcribe, corpus=args.corpus, category=args.category,
            chunk_seconds=chunk_s, preset=args.preset, limit=args.limit,
            ids=set(args.ids.split(",")) if args.ids else None,
            db=db, token_store=store,
        )
        summary = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in result.items() if k != "per_sample"
        }
        print(json.dumps(summary, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
