"""Training data: the v1 corpus as a CTC dataset (audio, token targets).

Copy of tilawa_tpu/train/data.py (numpy only) on the port's audio IO,
token store, manifest reader and alignments: the same seed gives bitwise
the same batches as the JAX package.

The reference's data pipeline builds NeMo manifests from Iqra/TTS/RetaSy/
TLOG sources (reference: scripts/train_fastconformer_phoneme_modal.py
prepare_data:330-816) — those sources need network access. In this
environment the decodable corpus audio + quran.json transcripts form an
overfit-scale dataset that exercises the identical loop mechanics
(variable-length batching, padded CTC loss, checkpointing).
"""

from __future__ import annotations

import numpy as np

from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
from tilawa_tpu_torch.data.token_store import TokenStore


def load_corpus_examples(
    corpus: str = "v1", max_audio_s: float = 20.0,
    only_ids: set[str] | None = None,
    return_ids: bool = False,
):
    """(waveform, target token ids) pairs for every decodable corpus clip.
    only_ids restricts to specific sample ids (hard-example continuation
    driven by tilawa_tpu.train.fit_report). return_ids=True yields
    (sample_id, waveform, token_ids) triples instead."""
    from tilawa_tpu_torch.eval.runner import load_manifest

    store = TokenStore.load_default()
    samples, corpus_dir = load_manifest(corpus)
    out = []
    for s in samples:
        if only_ids is not None and s["id"] not in only_ids:
            continue
        path = corpus_dir / s["file"]
        if not path.exists():
            continue
        try:
            audio = load_audio(path)
        except UnsupportedAudioFormat:
            continue
        if len(audio) > max_audio_s * 16000:
            continue
        ids: list[int] = []
        for e in s.get(
            "expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}]
        ):
            ids.extend(store.ids_for_key(e["surah"], e["ayah"]) or [])
        if ids:
            out.append((s["id"], audio, ids) if return_ids else (audio, ids))
    return out


def pad_batch(examples, audio_pad: int, token_pad: int):
    b = len(examples)
    audio = np.zeros((b, audio_pad), dtype=np.float32)
    audio_lens = np.zeros(b, dtype=np.int32)
    tokens = np.zeros((b, token_pad), dtype=np.int32)
    token_lens = np.zeros(b, dtype=np.int32)
    for i, (a, ids) in enumerate(examples):
        a = a[:audio_pad]
        ids = ids[:token_pad]
        audio[i, : len(a)] = a
        audio_lens[i] = len(a)
        tokens[i, : len(ids)] = ids
        token_lens[i] = len(ids)
    return audio, audio_lens, tokens, token_lens


def corpus_batches(
    batch_size: int = 8,
    corpus: str = "v1",
    seed: int = 0,
    max_audio_s: float = 20.0,
):
    """Infinite iterator of fixed-shape padded batches (one XLA program)."""
    examples = load_corpus_examples(corpus, max_audio_s=max_audio_s)
    if not examples:
        raise RuntimeError("no decodable training examples found")
    audio_pad = int(max_audio_s * 16000)
    token_pad = max(len(ids) for _a, ids in examples)
    token_pad = int(np.ceil(token_pad / 32) * 32)
    rng = np.random.default_rng(seed)
    idx = np.arange(len(examples))
    while True:
        rng.shuffle(idx)
        for chunk_start in range(0, len(idx) - batch_size + 1, batch_size):
            chunk = [examples[i] for i in idx[chunk_start : chunk_start + batch_size]]
            yield pad_batch(chunk, audio_pad, token_pad)


# (bucket seconds, batch size): roughly constant audio-samples per step so
# every bucket's XLA program has a similar cost; 7 compiled train-step
# shapes total (length-bucketed padding per SURVEY.md §7 Phase 2).
BUCKETS: list[tuple[float, int]] = [
    (8.0, 16), (12.0, 12), (16.0, 8), (24.0, 6), (32.0, 4), (48.0, 3), (64.0, 2),
    (96.0, 1), (160.0, 1),
]


def _augment(
    audio: np.ndarray, rng: np.random.Generator, pad: int,
    strength: str = "base",
) -> np.ndarray:
    """Speed perturb (0.9x-1.1x), gain, light noise — the reference trains
    with NeMo speed perturbation and tests with 0.9/1.0/1.1 TTA
    (reference: experiments/c2c-direct-mixed-tta/run.py:60-71).

    strength="strong" adds channel/speaker simulation for the held-out
    campaign (the corpus has a handful of reciters/recording chains; the
    reference's speaker invariance comes from 126K utterances the
    zero-egress environment cannot fetch — train_fastconformer_phoneme_
    modal.py:330-816): wider resampling (pitch+tempo), random biquad-ish
    EQ tilt, synthetic room reverb, soft clipping, and noise at real SNRs.
    """
    from tilawa_tpu_torch.data.audio import speed_perturb

    strong = strength == "strong"
    if rng.random() < (0.7 if strong else 0.5):
        lo, hi = (0.85, 1.18) if strong else (0.9, 1.1)
        factor = float(rng.uniform(lo, hi))
        if len(audio) * factor < pad:
            audio = speed_perturb(audio, factor)
    if strong:
        if rng.random() < 0.5:
            # spectral tilt / crude mic EQ: first-order filter
            # y[t] = x[t] + b*x[t-1] with b in [-0.6, 0.6] (b<0 brightens,
            # b>0 darkens), then a one-pole smoothing for low-pass moods
            b = float(rng.uniform(-0.6, 0.6))
            shifted = np.concatenate([audio[:1], audio[:-1]])
            audio = (audio + b * shifted) / (1.0 + abs(b))
        if rng.random() < 0.35:
            # synthetic room: exponential-decay noise IR, 60-250 ms
            ir_len = int(rng.uniform(0.06, 0.25) * 16000)
            t = np.arange(ir_len, dtype=np.float32)
            ir = rng.normal(size=ir_len).astype(np.float32) * np.exp(
                -t / (ir_len * float(rng.uniform(0.15, 0.4)))
            )
            ir[0] = 1.0
            wet = float(rng.uniform(0.1, 0.4))
            import scipy.signal as _sig

            rev = _sig.fftconvolve(audio, ir)[: len(audio)].astype(np.float32)
            peak = float(np.abs(rev).max() + 1e-8)
            audio = (1 - wet) * audio + wet * rev * (
                float(np.abs(audio).max() + 1e-8) / peak
            )
        if rng.random() < 0.25:
            # soft clip (cheap codec/input-stage distortion)
            drive = float(rng.uniform(1.5, 4.0))
            audio = np.tanh(audio * drive) / drive
    gain = float(rng.uniform(0.7, 1.3))
    audio = audio * gain
    noise_p = 0.6 if strong else 0.3
    if rng.random() < noise_p:
        rms = float(np.sqrt((audio**2).mean()) + 1e-8)
        scale = (
            rms * 10 ** (-float(rng.uniform(10, 30)) / 20)  # SNR 10-30 dB
            if strong else 0.02 * rms
        )
        audio = audio + rng.normal(scale=scale, size=audio.shape).astype(
            np.float32
        )
    return np.clip(audio, -1.0, 1.0).astype(np.float32)


def random_window_crop(
    audio: np.ndarray,
    ids: list[int],
    spans: np.ndarray,
    rng: np.random.Generator,
    min_crop_s: float = 1.2,
    silence_prob: float = 0.4,
    max_len: int | None = None,
) -> tuple[np.ndarray, list[int]]:
    """Cut a random audio window and keep the tokens fully inside it.

    Streaming feeds the encoder partial windows — prefixes during
    discovery, tail-trimmed suffixes while tracking, silence-padded tails
    at flush (reference windowing policy: tracker.ts:549-551,
    TAIL_SILENCE_SECONDS validate-streaming.ts:31; SURVEY.md §5.7). A model
    trained only on full clips collapses on those shapes; this crop, with
    labels derived from CTC forced alignment spans (train/align.py), is
    the training-time mirror of that serving distribution.

    spans: [L, 2] token (start, end) in sample units, aligned to `ids`.

    Window edges snap to the midpoints of inter-token gaps: a cut through
    the middle of a token leaves audible speech labelled as nothing, and
    CTC training on such windows teaches the encoder to suppress real
    speech toward blanks (measured: a mid-token-cut finetune collapsed
    full-clip decodes to near-empty within 1000 steps).
    """
    sr = 16000
    n = len(audio)
    L = len(ids)
    # candidate cut points: clip edges + inter-token gap midpoints
    cuts = np.empty(L + 1, np.int64)
    cuts[0] = 0
    cuts[-1] = n
    if L > 1:
        cuts[1:-1] = (spans[:-1, 1] + spans[1:, 0]) // 2
    min_len = min(n, int(min_crop_s * sr))

    mode = rng.random()
    if mode < 0.4:          # prefix (discovery window)
        i0 = 0
        valid = np.nonzero(cuts - cuts[0] >= min_len)[0]
        i1 = int(rng.choice(valid)) if len(valid) else L
    elif mode < 0.6:        # suffix (post-trim tracking window)
        i1 = L
        valid = np.nonzero(cuts[-1] - cuts >= min_len)[0]
        i0 = int(rng.choice(valid)) if len(valid) else 0
    else:                   # interior window
        i0 = int(rng.integers(0, L))
        valid = np.nonzero(cuts - cuts[i0] >= min_len)[0]
        i1 = int(rng.choice(valid)) if len(valid) else L
    s0, s1 = int(cuts[i0]), int(cuts[i1])
    kept = [ids[i] for i in range(i0, i1)]

    out = audio[s0:s1]
    if rng.random() < silence_prob:
        # real in-length silence (the tracker pads the flush window with
        # zeros INSIDE the valid length — the encoder must map it to blanks)
        tail = np.zeros(int(rng.uniform(0.2, 2.0) * sr), np.float32)
        out = np.concatenate([out, tail])
    if rng.random() < silence_prob * 0.5:
        out = np.concatenate(
            [np.zeros(int(rng.uniform(0.1, 0.5) * sr), np.float32), out]
        )
    if max_len is not None:
        out = out[:max_len]
    return out.astype(np.float32), kept


def _attach_spans(
    corpora: tuple[str, ...], examples_with_ids: list[tuple[str, np.ndarray, list[int]]]
) -> list[tuple[np.ndarray, list[int], np.ndarray | None]]:
    """Join (id, audio, tokens) with forced-alignment spans where known."""
    from tilawa_tpu_torch.train.align import load_alignments

    aligned: dict[str, dict] = {}
    for corpus in corpora:
        aligned.update(load_alignments(corpus))
    out = []
    for cid, audio, ids in examples_with_ids:
        entry = aligned.get(cid)
        spans = None
        if entry is not None and list(entry["token_ids"]) == list(ids):
            spans = np.stack([entry["starts"], entry["ends"]], axis=1)
        out.append((audio, ids, spans))
    return out


def bucketed_corpus_batches(
    corpora: tuple[str, ...] = ("v1", "v2", "v3"),
    seed: int = 0,
    augment: bool = True,
    buckets: list[tuple[float, int]] | None = None,
    weighting: str = "prop",
    only_ids: set[str] | None = None,
    rehearsal: float = 0.25,
    crop_prob: float = 0.0,
    aug_strength: str = "base",
):
    """Infinite iterator over length-bucketed batches from several corpora.

    Each bucket is one fixed (audio_pad, token_pad, batch) shape — a handful
    of XLA programs instead of one worst-case pad. Bucket sampling:
    weighting="prop" ∝ example count, "sqrt" ∝ sqrt(count) (oversamples the
    sparse long-audio buckets), "uniform" equal per bucket.

    only_ids focuses training on hard examples; `rehearsal` then mixes in
    that fraction of the full corpus anyway (anti-forgetting: a pure
    hard-only continuation measurably regressed the rest of the corpus).

    crop_prob > 0 replaces that fraction of examples with random window
    crops labelled via forced-alignment spans (random_window_crop) —
    the streaming-robustness axis. Examples without alignments always
    train full-length.
    """
    buckets = buckets or BUCKETS
    raw: list[tuple[str, np.ndarray, list[int]]] = []
    for corpus in corpora:
        raw.extend(
            load_corpus_examples(
                corpus, max_audio_s=buckets[-1][0], only_ids=only_ids,
                return_ids=True,
            )
        )
    if not raw:
        raise RuntimeError("no decodable training examples found")
    if only_ids is not None and rehearsal > 0:
        rng0 = np.random.default_rng(seed + 7)
        rest: list[tuple[str, np.ndarray, list[int]]] = []
        for corpus in corpora:
            rest.extend(
                load_corpus_examples(
                    corpus, max_audio_s=buckets[-1][0], return_ids=True
                )
            )
        n_mix = int(len(rest) * rehearsal)
        if n_mix:
            picks = rng0.choice(len(rest), size=n_mix, replace=False)
            raw.extend(rest[int(i)] for i in picks)
    examples = (
        _attach_spans(corpora, raw) if crop_prob > 0
        else [(a, ids, None) for _cid, a, ids in raw]
    )

    by_bucket: list[list[tuple[np.ndarray, list[int], np.ndarray | None]]] = [
        [] for _ in buckets
    ]
    for a, ids, spans in examples:
        for bi, (sec, _bs) in enumerate(buckets):
            if len(a) <= sec * 16000:
                by_bucket[bi].append((a, ids, spans))
                break
    live = [bi for bi, ex in enumerate(by_bucket) if ex]
    token_pads = []
    for bi, ex in enumerate(by_bucket):
        tp = max((len(ids) for _a, ids, _sp in ex), default=8)
        token_pads.append(int(np.ceil(tp / 16) * 16))
    weights = np.array([len(by_bucket[bi]) for bi in live], dtype=np.float64)
    if weighting == "sqrt":
        weights = np.sqrt(weights)
    elif weighting == "uniform":
        weights = np.ones_like(weights)
    weights /= weights.sum()

    rng = np.random.default_rng(seed)
    while True:
        bi = int(rng.choice(live, p=weights))
        sec, bs = buckets[bi]
        pad = int(sec * 16000)
        pool = by_bucket[bi]
        picks = rng.choice(len(pool), size=min(bs, len(pool)), replace=len(pool) < bs)
        chunk = []
        for i in picks:
            a, ids, spans = pool[int(i)]
            if spans is not None and len(spans) and rng.random() < crop_prob:
                a, ids = random_window_crop(a, ids, spans, rng, max_len=pad)
            if augment:
                a = _augment(a, rng, pad, strength=aug_strength)
            chunk.append((a, ids))
        while len(chunk) < bs:  # fixed batch dim per bucket
            chunk.append(chunk[len(chunk) % max(1, len(picks))])
        yield pad_batch(chunk, pad, token_pads[bi])


def synthetic_batches(
    batch_size: int = 4,
    n_samples: int = 16000,
    vocab: int = 1024,
    token_len: int = 12,
    seed: int = 0,
):
    """Deterministic synthetic batches for unit/dryrun use (no assets)."""
    rng = np.random.default_rng(seed)
    while True:
        audio = rng.normal(scale=0.1, size=(batch_size, n_samples)).astype(np.float32)
        audio_lens = np.full(batch_size, n_samples, dtype=np.int32)
        tokens = rng.integers(0, vocab, size=(batch_size, token_len)).astype(np.int32)
        token_lens = np.full(batch_size, token_len, dtype=np.int32)
        yield audio, audio_lens, tokens, token_lens
