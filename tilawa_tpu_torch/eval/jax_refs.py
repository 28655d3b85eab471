"""The JAX package's decisions on the v1 corpus, recorded live on the CPU.

The card cannot run the JAX package, and the records under
benchmark/results/ were taken on a TPU by earlier versions of it (the
streaming record predates the tracker's current Viterbi; the phoneme and
held-out records differ from today's JAX package on 3 and 2 clips). The
port's card gates compare with these files instead. Each is written by
`python tests/test_torch_refs.py` from the JAX package on the CPU (every
model with use_pallas=False) and holds, per clip id:

  streaming_v1.json  validate_streaming on exports/stream6-int8, 300 ms
                     chunks: "predicted" (emissions) and "final_sequence"
                     as [surah, ayah] lists, "sequence_accuracy"
  phoneme_v1.json    fastconformer-phoneme through the runner: "real"
                     (exports/phoneme-int8) and "oracle" (no bundle), and
                     both with TILAWA_PHONEME_RERANK=1 ("real_rerank",
                     "oracle_rerank"): the runner's "predicted" and
                     predict()'s "key" (surah, ayah, ayah_end),
                     "transcript" and "candidates" ([surah, ayah,
                     ayah_end, score]); with real acoustics also
                     "forwards": each forwarded encoder row's greedy "ids"
                     and per-frame top-two "gaps"
  heldout_v1.json    the heldout experiment (exports/heldout-int4, TTA)
                     through the runner: the same fields and "tta"
  sweep_buckets_v1.json
                     champion-int4 on each context-sweep row of chip_smoke's
                     clips whose own audio bucket is smaller than the
                     clip's, keyed "clip@prefix": the frames whose greedy id
                     differs between the two buckets and the largest
                     |Δ log-prob| between them (the reference's own
                     dependence on the padding, ROADMAP C.7)
"""

from __future__ import annotations

import json
from pathlib import Path

REFS_DIR = Path(__file__).resolve().parent / "refs"
STREAM_REF = REFS_DIR / "streaming_v1.json"
PHONEME_REF = REFS_DIR / "phoneme_v1.json"
HELDOUT_REF = REFS_DIR / "heldout_v1.json"
SWEEP_REF = REFS_DIR / "sweep_buckets_v1.json"


def load_ref(path: Path, section: str = "per_sample") -> dict[str, dict]:
    """{clip id: row} of one reference file (one section of it)."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)[section]


# The two packages' log-probs agree within this on every clip measured on the
# CPU (ROADMAP C.3: bf16 rounded at other points; 0.22-0.48 on phoneme-int8's
# v1 clips, 0.82 on champion-int4's 41 s clip); the card's kernels add up to
# 0.5 against the plain ops (chip_smoke's "plain path" phase).
LP_TOL = 1.0


def decision_row(result: dict, predicted: list[dict], forwards=()) -> dict:
    """The fields of one predict() result and its runner row that a gate
    compares: the runner's verses, the decision key, the transcript, the
    candidates with their scores and the TTA vote; with the (log-probs
    [T, V], valid frames) of every encoder row the prediction forwarded, in
    order, each row's greedy ids and top-two gaps."""
    def key(c):   # a single verse's ayah_end is None or its ayah: one form
        return [c.get("surah"), c.get("ayah"), c.get("ayah_end") or c.get("ayah")]

    return {
        "predicted": [[e["surah"], e["ayah"]] for e in predicted],
        "key": key(result),
        "transcript": result.get("transcript"),
        "candidates": [key(c) + [float(c.get("fused_score", c["score"]))]
                       for c in result.get("candidates") or []],
        "tta": result.get("tta"),
        **({"forwards": [greedy(lp, t) for lp, t in forwards]} if forwards else {}),
    }


def greedy(lp, t_valid: int) -> dict:
    """{"ids": argmax per valid frame, "gaps": top-two gap per frame}."""
    import numpy as np

    lp = np.asarray(lp, dtype=np.float32)[:t_valid]
    top2 = np.sort(lp, axis=-1)[:, -2:]
    return {"ids": lp.argmax(-1).tolist(),
            "gaps": [round(float(g), 5) for g in top2[:, 1] - top2[:, 0]]}


def flipped_frames(ref: dict, ours: dict) -> list[float] | None:
    """The reference's top-two gaps at the frames where the port's greedy
    ids differ from the reference's, over every forwarded row; None where
    the rows do not pair up (another count or length)."""
    a, b = ref.get("forwards"), ours.get("forwards")
    if not a or not b or len(a) != len(b) or any(
            len(x["ids"]) != len(y["ids"]) for x, y in zip(a, b)):
        return None
    return [g for x, y in zip(a, b) for i, j, g in zip(x["ids"], y["ids"], x["gaps"]) if i != j]


def greedy_near_tie(ref: dict, ours: dict, tol: float = LP_TOL) -> float | None:
    """The largest of the reference's top-two gaps at the frames where the
    port's greedy ids differ, when there are such frames and every one of
    those gaps is under `tol` (a decision moved by the packages' log-prob
    differences, ROADMAP C.9), else None."""
    gaps = flipped_frames(ref, ours)
    return max(gaps) if gaps and max(gaps) < tol else None


def near_tie(ref: dict, ours: dict) -> float | None:
    """The margin of the reference's decision when the port's differing
    pick is a near tie under ROADMAP C.6's rule, else None: the port's pick
    is one of the reference's candidates within the two packages' largest
    score difference on their common candidates of the reference's best, and
    the reference's best leads its runner-up by less than that difference."""
    def scores(row):
        return {tuple(c[:3]): c[3] for c in row["candidates"]}

    a, b = scores(ref), scores(ours)
    common = set(a) & set(b)
    delta = max((abs(a[k] - b[k]) for k in common), default=0.0)
    ranked = sorted(a.values(), reverse=True)
    pick = tuple(ours["key"])
    if len(ranked) > 1 and ranked[0] - ranked[1] < delta and pick in a \
            and a[pick] >= ranked[0] - delta:
        return ranked[0] - ranked[1]
    return None
