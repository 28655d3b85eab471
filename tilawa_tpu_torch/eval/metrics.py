"""Sequence scoring metrics — behavioral parity with the reference scorer
(reference: benchmark/runner.py:104-143 score_sequence): ordered-subsequence
recall, precision over predicted emissions, exact-sequence accuracy. Also
the exact-set accuracy variant used by streaming reports (reference:
EXPERIMENTS.md:5 ExactSetAcc vs OrderedSeqAcc distinction)."""

from __future__ import annotations


def score_sequence(expected: list[dict], predicted: list[dict]) -> dict:
    """Ordered-subsequence match: each expected verse counts as recalled if
    it appears in the prediction at/after the previous match position."""
    if not expected:
        return {"recall": 1.0, "precision": 1.0, "sequence_accuracy": 1.0}
    if not predicted:
        return {"recall": 0.0, "precision": 0.0, "sequence_accuracy": 0.0}

    pred = [(p["surah"], p["ayah"]) for p in predicted]
    exp = [(e["surah"], e["ayah"]) for e in expected]

    matched = 0
    pred_idx = 0
    matched_pred: set[int] = set()
    for e in exp:
        for j in range(pred_idx, len(pred)):
            if pred[j] == e:
                matched += 1
                matched_pred.add(j)
                pred_idx = j + 1
                break

    return {
        "recall": matched / len(exp),
        "precision": len(matched_pred) / len(pred),
        "sequence_accuracy": 1.0 if pred == exp else 0.0,
    }


def exact_set_accuracy(expected: list[dict], predicted: list[dict]) -> float:
    exp = {(e["surah"], e["ayah"]) for e in expected}
    pred = {(p["surah"], p["ayah"]) for p in predicted}
    return 1.0 if exp == pred else 0.0


def predict_to_emissions(predict_result: dict) -> list[dict]:
    """Expand a predict() dict (surah, ayah, ayah_end, score) into per-verse
    emissions (reference: benchmark/runner.py:211-228)."""
    if not predict_result or predict_result.get("surah", 0) == 0:
        return []
    surah = predict_result["surah"]
    start = predict_result["ayah"]
    end = predict_result.get("ayah_end") or start
    score = predict_result.get("score", 0.0)
    return [{"surah": surah, "ayah": a, "score": score} for a in range(start, end + 1)]


def best_emission_score(
    expected: list[dict],
    predicted: list[dict],
    also_accept: list[list[dict]] | None = None,
) -> dict:
    """Score against expected, taking the best over also_accept alternates
    (reference manifest field also_accept; runner treats alternates as
    equally correct)."""
    best = score_sequence(expected, predicted)
    for alt in also_accept or []:
        s = score_sequence(alt, predicted)
        if (s["sequence_accuracy"], s["recall"], s["precision"]) > (
            best["sequence_accuracy"], best["recall"], best["precision"]
        ):
            best = s
    return best
