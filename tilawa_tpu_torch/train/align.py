"""CTC forced alignment: token-level time spans for every corpus clip.

Port of tilawa_tpu/train/align.py: viterbi_align and load_alignments are
numpy copies; align_corpus runs the encoder through the port's
EncoderRuntime (on the card unless device="cpu").

The streaming tracker feeds the encoder *windows* of audio (prefixes,
suffixes after trims, silence-padded tails), but the training corpus only
has clip-level labels — so a model trained on full clips collapses on
partial windows (measured: v1 tracker-streaming seq-acc 0.16 vs batch
1.0). The reference sidesteps this because its phoneme model was trained
on short segments (reference: scripts/train_fastconformer_phoneme_modal.py
— per-verse clips). Our equivalent: derive token time spans from the
trained model itself via Viterbi alignment over the CTC lattice, then let
the data pipeline cut random crops whose labels are the tokens fully
inside the crop (tilawa_tpu/train/data.py crop augmentation).

Alignment is the standard 2L+1-state CTC Viterbi (states interleave
blanks and labels; transitions s→s, s-1→s, and s-2→s when labels differ),
run on host numpy over device-computed log-probs — a one-time pass over
~350 clips, cached in assets/alignments_{corpus}.npz.

Frame→sample mapping uses the fixed frontend geometry: mel hop 160 × 8x
conv subsampling = 1280 samples/frame (80 ms at 16 kHz).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SAMPLES_PER_FRAME = 1280  # 160-sample mel hop * 8x subsampling

ASSET_DIR = Path(__file__).resolve().parent.parent.parent / "assets"


def viterbi_align(
    log_probs: np.ndarray, tokens: list[int] | np.ndarray, blank_id: int
) -> np.ndarray | None:
    """Best CTC path for `tokens` through [T, V] log-probs.

    Returns [L, 2] int32 frame spans (start, end exclusive) per token, or
    None when infeasible (T < number of required frames).
    """
    tokens = np.asarray(tokens, dtype=np.int32)
    t_len, _v = log_probs.shape
    n = len(tokens)
    if n == 0:
        return np.zeros((0, 2), np.int32)
    s_len = 2 * n + 1
    # state s: even → blank, odd → tokens[(s-1)//2]
    state_ids = np.full(s_len, blank_id, np.int32)
    state_ids[1::2] = tokens
    # CTC feasibility: need at least one frame per label plus a blank
    # between equal neighbours (reference rule 2·len+1 ≤ T is conservative;
    # the exact minimum is n + #equal-neighbour pairs).
    min_frames = n + int(np.sum(tokens[1:] == tokens[:-1]))
    if t_len < min_frames:
        return None

    neg_inf = np.float32(-1e30)
    # skip transition s-2→s allowed into odd states whose label differs
    # from the label two states back
    can_skip = np.zeros(s_len, bool)
    for s in range(3, s_len, 2):
        can_skip[s] = tokens[(s - 1) // 2] != tokens[(s - 3) // 2]

    alpha = np.full(s_len, neg_inf, np.float32)
    emit = log_probs[0][state_ids]
    alpha[0] = emit[0]
    if s_len > 1:
        alpha[1] = emit[1]
    back = np.zeros((t_len, s_len), np.int8)  # 0=stay, 1=prev, 2=skip

    for t in range(1, t_len):
        stay = alpha
        prev = np.full(s_len, neg_inf, np.float32)
        prev[1:] = alpha[:-1]
        skip = np.full(s_len, neg_inf, np.float32)
        skip[2:] = alpha[:-2]
        skip[~can_skip] = neg_inf
        choice = np.argmax(np.stack([stay, prev, skip]), axis=0).astype(np.int8)
        best = np.maximum(stay, np.maximum(prev, skip))
        back[t] = choice
        alpha = best + log_probs[t][state_ids]

    s = int(np.argmax(alpha[max(0, s_len - 2):]) + max(0, s_len - 2))
    if alpha[s] <= neg_inf / 2:
        return None
    path = np.empty(t_len, np.int32)
    for t in range(t_len - 1, -1, -1):
        path[t] = s
        c = back[t][s]
        if c == 1:
            s -= 1
        elif c == 2:
            s -= 2

    spans = np.zeros((n, 2), np.int32)
    for i in range(n):
        frames = np.nonzero(path == 2 * i + 1)[0]
        spans[i] = (frames[0], frames[-1] + 1)
    return spans


def align_corpus(
    corpus: str = "v1",
    runtime=None,
    cache: bool = True,
    batch_size: int = 8,
    device: str = "cuda",
) -> dict[str, dict]:
    """id → {token_ids, starts, ends} (sample units) for every decodable
    clip; cached in assets/alignments_{corpus}.npz."""
    cache_path = ASSET_DIR / f"alignments_{corpus}.npz"
    if cache and cache_path.exists():
        return load_alignments(corpus)

    from tilawa_tpu_torch.data.assets import BLANK_ID
    from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
    from tilawa_tpu_torch.data.token_store import TokenStore
    from tilawa_tpu_torch.eval.runner import load_manifest

    if runtime is None:
        from tilawa_tpu_torch.eval.experiments import _load_runtime

        runtime = _load_runtime(quant="int4", device=device)

    store = TokenStore.load_default()
    samples, corpus_dir = load_manifest(corpus)
    clips: list[tuple[str, np.ndarray, list[int]]] = []
    for s in samples:
        path = corpus_dir / s["file"]
        if not path.exists():
            continue
        try:
            audio = load_audio(path)
        except UnsupportedAudioFormat:
            continue
        ids: list[int] = []
        for e in s.get(
            "expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}]
        ):
            ids.extend(store.ids_for_key(e["surah"], e["ayah"]) or [])
        if ids:
            clips.append((s["id"], audio, ids))

    out: dict[str, dict] = {}
    # batch by length so log_probs_batch shares one bucket per dispatch
    clips.sort(key=lambda c: len(c[1]))
    for i in range(0, len(clips), batch_size):
        chunk = clips[i : i + batch_size]
        lps, t_valids = runtime.log_probs_batch([a for _i, a, _t in chunk])
        lps = np.asarray(lps)
        for j, (cid, audio, ids) in enumerate(chunk):
            t_valid = int(t_valids[j])
            spans = viterbi_align(lps[j, :t_valid], ids, BLANK_ID)
            if spans is None:
                continue
            out[cid] = {
                "token_ids": np.asarray(ids, np.int32),
                "starts": spans[:, 0] * SAMPLES_PER_FRAME,
                "ends": np.minimum(spans[:, 1] * SAMPLES_PER_FRAME, len(audio)),
            }

    if cache:
        flat: dict[str, np.ndarray] = {}
        for cid, entry in out.items():
            for k, v in entry.items():
                flat[f"{cid}::{k}"] = v
        ASSET_DIR.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache_path, **flat)
    return out


def load_alignments(corpus: str = "v1") -> dict[str, dict]:
    cache_path = ASSET_DIR / f"alignments_{corpus}.npz"
    if not cache_path.exists():
        return {}
    data = np.load(cache_path)
    out: dict[str, dict] = {}
    for key in data.files:
        cid, field = key.rsplit("::", 1)
        out.setdefault(cid, {})[field] = data[key]
    return out


def main(argv=None) -> int:  # pragma: no cover - CLI
    import argparse

    parser = argparse.ArgumentParser(description="CTC forced alignment")
    parser.add_argument("--corpus", default="v1")
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cache_path = ASSET_DIR / f"alignments_{args.corpus}.npz"
    if args.force and cache_path.exists():
        cache_path.unlink()
    aligned = align_corpus(args.corpus, device=args.device)
    durs = [
        (e["ends"][-1] - e["starts"][0]) / 16000 for e in aligned.values() if len(e["starts"])
    ]
    print(
        f"{args.corpus}: aligned {len(aligned)} clips; "
        f"mean voiced span {np.mean(durs):.1f}s" if durs else "none aligned"
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
