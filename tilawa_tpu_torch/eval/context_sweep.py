"""Context-sweep diagnostic: decode quality and stability vs audio-prefix
length.

The measurement that motivated the reference's decode-stability gate
(reference: web/frontend/test/diagnose-context-sweep.ts:1-21 — phoneme
WER on 1/2/3/5/10s prefixes vs (a) the expected reference and (b) the
full-audio decode, EXPERIMENTS.md:34-48). If prefix decodes are unstable
against the full decode, streaming needs gating/deferral; if WER is flat
above ~2s, the streaming gap lives elsewhere.

TPU-first restructure: all prefix cuts of a sample run as ONE batched
bucket-padded encoder dispatch (runtime.log_probs_batch) instead of the
reference's serial per-prefix ONNX calls, and the metric space is the
model's BPE token ids (token-level edit distance) rather than phoneme
strings.

Port of tilawa_tpu/eval/context_sweep.py on the torch runtime: the cuts of
a clip are B = 2–6 rows of one log_probs_batch forward, padded to the full
clip's audio bucket; on the card the encoder's rows are bitwise independent
of B, so a row decodes as it would alone at that bucket.

Usage (on the card; --device cpu for the plain ops):
  python -m tilawa_tpu_torch.eval.context_sweep --corpus v1 --max-samples 10
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
from tilawa_tpu_torch.data.token_store import TokenStore
from tilawa_tpu_torch.eval.runner import load_manifest
from tilawa_tpu_torch.ops.ctc import collapse_ctc

SAMPLE_RATE = 16000
CONTEXT_SECONDS = (1.0, 2.0, 3.0, 5.0, 10.0)  # plus "full"


def token_edits(ref: list[int], hyp: list[int]) -> int:
    """Levenshtein distance on token-id sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, np.int32)
        cur[0] = i
        sub = prev[:-1] + (np.asarray(hyp) != ref[i - 1])
        for j in range(1, m + 1):
            cur[j] = min(sub[j - 1], prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return int(prev[m])


def lcp_len(a: list[int], b: list[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def sweep_pieces(
    audio: np.ndarray, contexts=CONTEXT_SECONDS
) -> tuple[list[str], list[np.ndarray]]:
    """(keys, audio pieces): every prefix cut shorter than the clip, then
    the whole clip ("full")."""
    dur = len(audio) / SAMPLE_RATE
    cuts = [c for c in contexts if c < dur]
    pieces = [audio[: int(c * SAMPLE_RATE)] for c in cuts] + [audio]
    return [f"{c:g}" for c in cuts] + ["full"], pieces


def sweep_sample(
    runtime, audio: np.ndarray, contexts=CONTEXT_SECONDS
) -> dict[str, list[int]]:
    """Decode every prefix cut + full audio in one batched dispatch.
    Returns {"1.0": ids, ..., "full": ids}."""
    keys, pieces = sweep_pieces(audio, contexts)
    lps, t_valids = runtime.log_probs_batch(pieces)
    lps = np.asarray(lps)
    out: dict[str, list[int]] = {}
    for i, key in enumerate(keys):
        ids = lps[i, : int(t_valids[i])].argmax(axis=-1)
        out[key] = list(collapse_ctc(ids, runtime.blank_id))
    return out


def run_sweep(
    runtime,
    corpus: str = "v1",
    max_samples: int = 0,
    contexts=CONTEXT_SECONDS,
    verbose: bool = True,
    ids: set[str] | None = None,
) -> dict:
    """The sweep over a corpus (or the samples whose id is in `ids`)."""
    store = TokenStore.load_default()
    samples, corpus_dir = load_manifest(corpus)
    if ids is not None:
        samples = [s for s in samples if s["id"] in ids]
    if max_samples:
        samples = samples[:max_samples]

    keys = [f"{c:g}" for c in contexts]
    ref_buckets = {k: [0, 0, 0] for k in [*keys, "full"]}  # edits, reflen, n
    stab_buckets = {k: [0, 0, 0] for k in keys}            # diff, declen, n

    for s in samples:
        path = corpus_dir / s["file"]
        if not path.exists():
            continue
        try:
            audio = load_audio(path)
        except UnsupportedAudioFormat:
            continue
        expected: list[int] = []
        for e in s.get(
            "expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}]
        ):
            expected.extend(store.ids_for_key(e["surah"], e["ayah"]) or [])
        if not expected:
            continue

        decodes = sweep_sample(runtime, audio, contexts)
        full = decodes["full"]
        fe = token_edits(expected, full)
        ref_buckets["full"][0] += fe
        ref_buckets["full"][1] += len(expected)
        ref_buckets["full"][2] += 1
        line = [
            f"{s['id']:<26} dur={len(audio)/SAMPLE_RATE:.1f}s "
            f"ref={len(expected)}t fullWer={fe/max(len(expected),1):.2f}"
        ]
        for k in keys:
            if k not in decodes:
                continue
            dec = decodes[k]
            e = token_edits(expected, dec)
            ref_buckets[k][0] += e
            ref_buckets[k][1] += len(expected)
            ref_buckets[k][2] += 1
            lcp = lcp_len(dec, full)
            stab_buckets[k][0] += len(dec) - lcp
            stab_buckets[k][1] += len(dec)
            stab_buckets[k][2] += 1
            stab = lcp / len(dec) if dec else 1.0
            line.append(f" {k}s: wer={e/max(len(expected),1):.2f} stab={stab:.2f}")
        if verbose:
            print("".join(line))

    def table(buckets):
        return {
            k: {
                "value": round(b[0] / b[1], 4) if b[1] else None,
                "n": b[2],
            }
            for k, b in buckets.items()
        }

    return {"wer_vs_reference": table(ref_buckets),
            "instability_vs_full": table(stab_buckets)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="context-sweep diagnostic")
    parser.add_argument("--corpus", default="v1")
    parser.add_argument("--max-samples", type=int, default=0)
    parser.add_argument("--quant", default="int4")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain ops)")
    args = parser.parse_args(argv)

    from tilawa_tpu_torch.eval.experiments import _load_runtime

    runtime = _load_runtime(quant=args.quant or None, device=args.device)
    result = run_sweep(runtime, corpus=args.corpus, max_samples=args.max_samples)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
