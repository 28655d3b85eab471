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
  streaming_tta_v1.json
                     the same replay with the window TTA on
                     (TILAWA_STREAM_TTA; pipeline/predict.py STREAM_TTA):
                     "predicted", "final_sequence", "sequence_accuracy",
                     "tta_cycles" (the cycles that forwarded the window and
                     its 0.9x variant) and "kept": each such cycle's
                     [len(d0), len(d1)], the collapsed decodes of the window
                     and the variant (pipeline/predict.py keeps_variant
                     picks from them), and "silent": the cycles whose window
                     is all zeros
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
from contextlib import contextmanager
from pathlib import Path

REFS_DIR = Path(__file__).resolve().parent / "refs"
STREAM_REF = REFS_DIR / "streaming_v1.json"
STREAM_TTA_REF = REFS_DIR / "streaming_tta_v1.json"
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


def tta_lengths(lens, ids_b, blank_id: int) -> list[int]:
    """[len(d0), len(d1)] of one window TTA forward_batch: the collapsed
    greedy decodes of its two rows over their own valid frames."""
    from tilawa_tpu_torch.ops.ctc import collapse_ctc

    return [len(collapse_ctc(ids_b[i][: int(lens[i])], blank_id)) for i in range(2)]


# The JAX package's normalized log-mel of an all-zero window on the CPU: 1.0
# on every valid frame and bin (tests/test_torch_stream_tta.py holds it at
# lengths of 16,000 to 64,000 samples). Its log-mel is one constant there, so
# the true (x - mean) / std is 0 / 0: XLA's f32 mean of the equal values
# rounds below them and the quotient is 1, where the port's sums give other
# values by length (ROADMAP C.11).
JAX_SILENT_FEATURE = 1.0


@contextmanager
def jax_silent_features():
    """While inside, the port's log-mel normalization gives each row whose
    valid log-mel is one constant (an all-zero window) the JAX package's
    features, JAX_SILENT_FEATURE on every valid frame, and every other row
    its own. A diagnostic of C.11 for the replays that compare with the JAX
    package; no served path enters it."""
    import torch

    from tilawa_tpu_torch.ops import frontend

    real = frontend.normalize_log_mel

    def normalize(logmel, lengths):
        normed, feat_lengths = real(logmel, lengths)
        valid = (torch.arange(logmel.shape[1], device=logmel.device)[None, :]
                 < feat_lengths[:, None])[..., None]
        const = torch.where(valid, logmel == logmel[:, :1, :1], True).flatten(1).all(1)
        return torch.where(const[:, None, None] & valid, JAX_SILENT_FEATURE, normed), \
            feat_lengths

    frontend.normalize_log_mel = normalize
    try:
        yield
    finally:
        frontend.normalize_log_mel = real


def tta_parting(ref: dict, ours: dict) -> int | None:
    """The first TTA cycle whose [len(d0), len(d1)] differ between two rows
    of STREAM_TTA_REF's form (or that only one of them ran), None where
    every cycle agrees."""
    a, b = ref["kept"], ours["kept"]
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if list(x) != list(y)),
             min(len(a), len(b)))
    return None if i == len(a) == len(b) else i


def tta_pick_near_tie(ref: dict, ours: dict) -> tuple[int, int] | None:
    """(cycle, the reference's len(d1) - len(d0) there) at the cycle where
    the two replays part, when that margin is 1 or 2, so that one token
    either way makes the other choice (ROADMAP C.3's near ties, extended to
    the pick); else None."""
    i = tta_parting(ref, ours)
    if i is None or i >= min(len(ref["kept"]), len(ours["kept"])):
        return None
    margin = ref["kept"][i][1] - ref["kept"][i][0]
    return (i, margin) if margin in (1, 2) else None
