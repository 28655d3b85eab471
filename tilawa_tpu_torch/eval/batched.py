"""Whole-corpus batched evaluation: the throughput path.

Port of tilawa_tpu/eval/batched.py. Clips are grouped by audio-length
bucket, each group runs as [batch_size, bucket] encoder forwards (the last
batch of a bucket padded with zero waves, so every bucket has one batch
shape), and the host decision stack (decode → retrieval → rerank) runs per
clip on the device-resident log-probs. The bench's batched audio-s/s
comes from here.

Pipelining: forwards are queued with EncoderRuntime.forward_batch_async,
which returns before the device has run them (no host sync in the upload
or the forward), and the host decision stack consumes batch i while the
device runs batches i+1..i+k, at most MAX_INFLIGHT in flight, so device
memory stays O(window). The stream runs in order, so consuming in queue
order never waits on a later batch. fetch_wait_s is the time the host
blocks on a batch's ids.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from fractions import Fraction

import numpy as np

from tilawa_tpu_torch.data.audio import speed_perturb
from tilawa_tpu_torch.eval.metrics import predict_to_emissions, score_sequence
from tilawa_tpu_torch.pipeline.predict import TTA_FACTORS, TTA_SKIP_THRESHOLD
from tilawa_tpu_torch.pipeline.runtime import LONG_THRESHOLD, bucket_length

# Bounded device-side queue: each in-flight batch holds a [B, T, 1025] f32
# log-prob buffer on the device; 6 batches bound that at tens to hundreds
# of MB while keeping the device several forwards ahead of the host.
MAX_INFLIGHT = 6


def variant_length(n: int, factor: float) -> int:
    """Exact sample count speed_perturb produces: resample_poly(up, down)
    yields ceil(n * up / down) samples (0.9x makes audio SHORTER)."""
    if factor == 1.0:
        return n
    frac = Fraction(factor).limit_denominator(100)
    return -((-n * frac.numerator) // frac.denominator)


def batched_corpus_eval(
    recognizer,
    audios: list[tuple[str, np.ndarray, list[dict]]],
    batch_size: int = 8,
) -> dict:
    """audios: (sample_id, waveform, expected_verses) triples.

    Returns per-sample predictions plus throughput metrics. The encoder
    runs bucket-batched; decode/retrieval/rerank run per clip on the
    device-resident log-probs, overlapped with the remaining forward queue.
    """
    runtime = recognizer.runtime
    groups: dict[int, list[int]] = defaultdict(list)
    long_idxs: list[int] = []
    use_chunking = runtime.long_chunking

    def is_long(n_samples: int) -> bool:
        return use_chunking and n_samples > LONG_THRESHOLD

    for i, (_sid, audio, _exp) in enumerate(audios):
        if is_long(len(audio)):
            # Crop-trained models: long clips take the chunked stitched
            # forward, itself a [K, LONG_CHUNK] batch.
            long_idxs.append(i)
        else:
            groups[bucket_length(len(audio))].append(i)

    # Warm-up (uncounted; the reference excludes warm-up too,
    # benchmark/runner.py:271-280). The JAX package compiles one program
    # per shape here; eager torch compiles nothing, but the first forward
    # of a shape pays the caching allocator's growth to that shape's
    # buffers and cuDNN's choice of convolution algorithm for it. So each
    # shape the timed pass can launch runs once: every bucket of the main
    # pass and of the TTA variants (0.9x shortens audio, 1.1x lengthens
    # it) at batch_size rows, and each long chunk count once.
    tta_buckets: set[int] = set()
    tta_long_lens: list[int] = []
    if recognizer.tta:
        for _sid, a, _exp in audios:
            for f in TTA_FACTORS:
                vn = variant_length(len(a), f)
                if is_long(vn):
                    tta_long_lens.append(vn)
                else:
                    tta_buckets.add(bucket_length(vn))
    for bucket in sorted(set(groups) | tta_buckets):
        runtime.forward_batch([np.zeros(bucket, np.float32)] * batch_size)
    warm_k: set[int] = set()
    for n in [len(audios[i][1]) for i in long_idxs] + tta_long_lens:
        k = runtime.chunk_count(n)
        if k not in warm_k:
            warm_k.add(k)
            runtime.forward_long(np.zeros(n, np.float32))

    predictions: dict[int, dict] = {}
    stage = {"fetch_wait_s": 0.0, "decode_s": 0.0, "predict_s": 0.0}

    def consume(chunk: list[int], lp_dev, packed_dev, pred: dict) -> None:
        t0 = time.perf_counter()
        packed = packed_dev.cpu().numpy()  # blocks until this batch is done
        t1 = time.perf_counter()
        stage["fetch_wait_s"] += t1 - t0
        t_valids, ids_b = packed[:, 0], packed[:, 1:]
        for j, i in enumerate(chunk):
            t_valid = int(t_valids[j])
            td = time.perf_counter()
            transcript = recognizer.decode_ids(ids_b[j, :t_valid])
            tp = time.perf_counter()
            pred[i] = recognizer._predict_from_logprobs(lp_dev[j], t_valid, transcript)
            te = time.perf_counter()
            stage["decode_s"] += tp - td
            stage["predict_s"] += te - tp

    def run_pipelined(
        batches: list[tuple[list[int], list[np.ndarray]]], pred: dict
    ) -> None:
        """Queue forwards ahead of the host stack with a bounded window."""
        inflight: deque = deque()
        for chunk, waves in batches:
            if len(inflight) >= MAX_INFLIGHT:
                consume(*inflight.popleft(), pred)
            inflight.append((chunk, *runtime.forward_batch_async(waves)))
        while inflight:
            consume(*inflight.popleft(), pred)

    def make_batches(
        idx_groups: dict[int, list[int]], wave_of
    ) -> list[tuple[list[int], list[np.ndarray]]]:
        batches = []
        for bucket, idxs in sorted(idx_groups.items()):
            for pos in range(0, len(idxs), batch_size):
                chunk = idxs[pos:pos + batch_size]
                waves = [wave_of(i) for i in chunk]
                while len(waves) < batch_size:  # one batch shape per bucket
                    waves.append(np.zeros(bucket, np.float32))
                batches.append((chunk, waves))
        return batches

    total_audio_s = sum(len(a) / 16000.0 for _sid, a, _exp in audios)
    t0 = time.perf_counter()
    run_pipelined(make_batches(groups, lambda i: audios[i][1]), predictions)
    for i in long_idxs:
        lp, ids, t_valid = runtime.forward_long(audios[i][1])
        predictions[i] = recognizer._predict_from_logprobs(
            lp, t_valid, recognizer.decode_ids(ids)
        )
    forward_s = stage["fetch_wait_s"]

    # ---- TTA pass (reference: c2c-direct-mixed-tta/run.py): low-confidence
    # clips re-run at 0.9x/1.1x. The per-clip path runs one [2, bucket]
    # forward per hard clip; here all hard clips' variants batch together
    # per bucket, so the TTA-inclusive throughput stays a batched number.
    n_tta = 0
    if recognizer.tta:
        hard = [i for i in range(len(audios)) if predictions[i]["score"] < TTA_SKIP_THRESHOLD]
        n_tta = len(hard)
        variants: list[tuple[int, np.ndarray]] = []
        for i in hard:
            for f in TTA_FACTORS:
                variants.append((i, speed_perturb(audios[i][1], f)))
        vpred: dict[int, dict] = {}
        vgroups: dict[int, list[int]] = defaultdict(list)
        vlong: list[int] = []
        for vi, (_i, w) in enumerate(variants):
            if is_long(len(w)):
                vlong.append(vi)
            else:
                vgroups[bucket_length(len(w))].append(vi)
        run_pipelined(make_batches(vgroups, lambda vi: variants[vi][1]), vpred)
        for vi in vlong:
            # as the main pass: the chunked stitched forward, warmed above
            lp, ids, tv = runtime.forward_long(variants[vi][1])
            vpred[vi] = recognizer._predict_from_logprobs(lp, tv, recognizer.decode_ids(ids))
        for pos, i in enumerate(hard):
            p09, p11 = vpred[2 * pos], vpred[2 * pos + 1]
            predictions[i] = recognizer.tta_vote([p09, predictions[i], p11])
    wall = time.perf_counter() - t0

    scores = {"recall": 0.0, "precision": 0.0, "sequence_accuracy": 0.0}
    n = len(audios)
    for i, (_sid, _audio, expected) in enumerate(audios):
        s = score_sequence(expected, predict_to_emissions(predictions[i]))
        for k in scores:
            scores[k] += s[k]

    return {
        "n": n,
        "n_tta": n_tta,
        "wall_s": round(wall, 3),
        "forward_s": round(forward_s, 3),
        "fetch_wait_s": round(stage["fetch_wait_s"], 3),
        "decode_s": round(stage["decode_s"], 3),
        "predict_s": round(stage["predict_s"], 3),
        "audio_s": round(total_audio_s, 1),
        "audio_sec_per_sec": round(total_audio_s / wall, 2) if wall else None,
        "recall": round(scores["recall"] / n, 4) if n else None,
        "precision": round(scores["precision"] / n, 4) if n else None,
        "seq_acc": round(scores["sequence_accuracy"] / n, 4) if n else None,
        "predictions": {audios[i][0]: predictions[i] for i in range(n)},
    }
