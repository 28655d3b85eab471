"""Phoneme-level alignment and word-level correction mapping (a copy of
tilawa_tpu/text/phonemes.py; host code, no framework).

Capability parity with the reference's mispronunciation stack
(reference: shared/phoneme_aligner.py:8-166 — Levenshtein DP + backtrace →
per-position substitution/deletion/insertion labels, PER, correct-rate;
web/frontend/src/lib/correction.ts:20-91 — phoneme errors grouped into
word-level corrections via `|` boundary bookkeeping).

These are short-sequence host-side policy ops (a verse is < 200 phonemes);
the corpus-scale edit-distance scans live in the native library
(text/levenshtein.py). Alignment here needs the full backtrace,
which the distance-only native kernels deliberately don't compute.
"""

from __future__ import annotations

from dataclasses import dataclass, field

WORD_BOUNDARY = "|"


@dataclass
class AlignmentError:
    type: str  # "substitution" | "deletion" | "insertion"
    position: int  # position in the reference sequence
    expected: str | None
    got: str | None

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "position": self.position,
            "expected": self.expected,
            "got": self.got,
        }


@dataclass
class AlignmentResult:
    errors: list[AlignmentError] = field(default_factory=list)
    per: float = 0.0
    correct_rate: float = 1.0
    alignment: list[tuple[str | None, str | None]] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "errors": [e.to_dict() for e in self.errors],
            "per": self.per,
            "correct_rate": self.correct_rate,
            "alignment": self.alignment,
        }


def align_phonemes(predicted: list[str], reference: list[str]) -> AlignmentResult:
    """Optimal edit alignment of predicted vs reference phoneme tokens.

    Tie-break order matches the reference (substitution/match > deletion >
    insertion, shared/phoneme_aligner.py:84-91) so error labels are
    reproducible 1:1. PER = edits / len(reference); empty-reference edge
    cases follow shared/phoneme_aligner.py:30-62.
    """
    n, m = len(reference), len(predicted)
    if n == 0 and m == 0:
        return AlignmentResult()
    if n == 0:
        errs = [AlignmentError("insertion", 0, None, p) for p in predicted]
        return AlignmentResult(errs, float(m), 0.0, [(None, p) for p in predicted])
    if m == 0:
        errs = [AlignmentError("deletion", i, r, None) for i, r in enumerate(reference)]
        return AlignmentResult(errs, 1.0, 0.0, [(r, None) for r in reference])

    # DP over (n+1) x (m+1); bt codes: 0=sub/match, 1=deletion, 2=insertion.
    prev = list(range(m + 1))
    bt = [[2] * (m + 1)]
    bt[0][0] = -1
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        row = [1] + [0] * m
        ref_tok = reference[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (0 if ref_tok == predicted[j - 1] else 1)
            delete = prev[j] + 1
            ins = cur[j - 1] + 1
            best = min(sub, ins, delete)
            cur[j] = best
            row[j] = 0 if best == sub else (1 if best == delete else 2)
        bt.append(row)
        prev = cur

    alignment: list[tuple[str | None, str | None]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i == 0:
            alignment.append((None, predicted[j - 1]))
            j -= 1
        elif j == 0:
            alignment.append((reference[i - 1], None))
            i -= 1
        else:
            move = bt[i][j]
            if move == 0:
                alignment.append((reference[i - 1], predicted[j - 1]))
                i -= 1
                j -= 1
            elif move == 1:
                alignment.append((reference[i - 1], None))
                i -= 1
            else:
                alignment.append((None, predicted[j - 1]))
                j -= 1
    alignment.reverse()

    errors: list[AlignmentError] = []
    correct = 0
    ref_pos = 0
    for ref_tok, pred_tok in alignment:
        if ref_tok is not None and pred_tok is not None:
            if ref_tok == pred_tok:
                correct += 1
            else:
                errors.append(AlignmentError("substitution", ref_pos, ref_tok, pred_tok))
            ref_pos += 1
        elif ref_tok is not None:
            errors.append(AlignmentError("deletion", ref_pos, ref_tok, None))
            ref_pos += 1
        else:
            errors.append(AlignmentError("insertion", ref_pos, None, pred_tok))

    return AlignmentResult(errors, len(errors) / n, correct / n, alignment)


def align_phoneme_strings(predicted: str, reference: str) -> AlignmentResult:
    """Space-separated phoneme strings (shared/phoneme_aligner.py:161-166)."""
    return align_phonemes(
        predicted.split() if predicted.strip() else [],
        reference.split() if reference.strip() else [],
    )


def word_corrections(
    predicted_raw: str,
    reference_raw: str,
    max_word_index: int | None = None,
) -> list[dict]:
    """Phoneme alignment errors → word-level corrections.

    `|` marks word boundaries in both raw strings; boundaries are stripped
    before alignment and reference positions are mapped back to word
    indices (reference: lib/correction.ts:30-91). `max_word_index` caps
    reporting to the recited portion (exclusive).
    """
    pred_tokens = predicted_raw.split()
    ref_tokens = reference_raw.split()
    if not pred_tokens or not ref_tokens:
        return []

    ref_clean: list[str] = []
    ref_clean_to_word: list[int] = []
    wi = 0
    for tok in ref_tokens:
        if tok == WORD_BOUNDARY:
            wi += 1
        else:
            ref_clean.append(tok)
            ref_clean_to_word.append(wi)
    pred_clean = [t for t in pred_tokens if t != WORD_BOUNDARY]

    result = align_phonemes(pred_clean, ref_clean)
    if not result.errors:
        return []

    by_word: dict[int, dict] = {}
    for err in result.errors:
        w_idx = (
            ref_clean_to_word[err.position]
            if err.position < len(ref_clean_to_word)
            else (ref_clean_to_word[-1] if ref_clean_to_word else 0)
        )
        if max_word_index is not None and w_idx >= max_word_index:
            continue
        entry = by_word.setdefault(
            w_idx, {"expected": [], "got": [], "type": err.type}
        )
        if err.expected:
            entry["expected"].append(err.expected)
        if err.got:
            entry["got"].append(err.got)
        if err.type == "substitution":
            entry["type"] = "substitution"

    return [
        {
            "word_index": w_idx,
            "expected": "".join(info["expected"]),
            "got": "".join(info["got"]),
            "error_type": info["type"],
        }
        for w_idx, info in by_word.items()
    ]
