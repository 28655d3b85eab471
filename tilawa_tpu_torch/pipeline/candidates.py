"""Candidate retrieval for the CTC rerank — the reference's three-strategy
build (reference: experiments/c2c-direct/run.py:251-311):

  pass 1: trigram-indexed match_verse (top-100 runners-up kept)
  pass 2: full fragment-score search top-100
  pass 3: full spaced+spaceless Levenshtein scan top-100
  + multi-ayah span enumeration (MAX_SPAN window) around the top-80 refs

Our passes 2 and 3 run as batched native corpus scans. Tunables keep the
reference's env-var override convention (§5.6 config mechanism #1).
"""

from __future__ import annotations

import os

from tilawa_tpu_torch.data.quran import QuranDB

TOP_TEXT = int(os.getenv("TILAWA_TOP_TEXT", "100"))
TOP_SPAN_REFS = int(os.getenv("TILAWA_TOP_SPAN_REFS", "80"))
MAX_SPAN = int(os.getenv("TILAWA_MAX_SPAN", "6"))


def _add(out: list[dict], seen: set, cand: dict) -> None:
    c = dict(cand)
    c["ayah_end"] = c.get("ayah_end") or c["ayah"]
    if not c.get("ctc_text"):
        c["ctc_text"] = c.get("text_clean") or ""
    key = (c["surah"], c["ayah"], c["ayah_end"])
    if key not in seen and c["ctc_text"].strip():
        seen.add(key)
        out.append(c)


def make_span(db: QuranDB, surah: int, start: int, end: int) -> dict | None:
    text = db.span_text(surah, start, end)
    if text is None:
        return None
    return {
        "surah": surah,
        "ayah": start,
        "ayah_end": end,
        "text_clean": text,
        "ctc_text": text,
        "score": 0.0,
    }


_UNSET = object()


def text_match(
    db: QuranDB,
    transcript: str,
    top_text: int = TOP_TEXT,
    max_span: int = MAX_SPAN,
) -> dict | None:
    """Pass 1 alone: the trigram-indexed text match whose score drives the
    0.80 confidence gate. Exposed separately so predict() can skip the
    expensive passes 2/3 + span enumeration entirely when the gate passes
    (the reference always builds all candidates before gating,
    c2c-direct/run.py:394-445 — same results, wasted work)."""
    return db.match_verse(
        transcript,
        threshold=0.0,
        max_span=max_span,
        return_top_k=top_text,
        use_trigram_index=True,
        seeded_spans=True,
    )


def build_candidates(
    db: QuranDB,
    transcript: str,
    top_text: int = TOP_TEXT,
    top_span_refs: int = TOP_SPAN_REFS,
    max_span: int = MAX_SPAN,
    base: dict | None | object = _UNSET,
) -> tuple[list[dict], dict | None]:
    """Returns (candidates, base_text_match). `transcript` must already be
    normalized. Pass `base` (from text_match) to reuse an existing pass-1
    result."""
    out: list[dict] = []
    seen: set = set()
    single_refs: list[tuple[int, int]] = []

    # Pass 1: trigram-indexed match (may return a span).
    if base is _UNSET:
        base = text_match(db, transcript, top_text, max_span)
    if base:
        _add(out, seen, base)
        single_refs.append((base["surah"], base["ayah"]))
        for ru in base.get("runners_up", []):
            verse = db.get_verse(ru["surah"], ru["ayah"])
            if verse:
                c = dict(verse)
                c["score"] = ru.get("score", 0.0)
                _add(out, seen, c)
                single_refs.append((c["surah"], c["ayah"]))

    # Pass 2: full fragment-score search.
    for verse in db.search(transcript, top_k=top_text):
        _add(out, seen, verse)
        single_refs.append((verse["surah"], verse["ayah"]))

    # Pass 3: spaced + spaceless full scan.
    for verse in db.spaceless_scan(transcript, top_k=top_text):
        _add(out, seen, verse)
        single_refs.append((verse["surah"], verse["ayah"]))

    # Span candidates around the top single-verse refs.
    for surah, ayah in single_refs[:top_span_refs]:
        verses = db.get_surah(surah)
        max_ayah = len(verses)
        for start in range(max(1, ayah - max_span + 1), min(ayah, max_ayah) + 1):
            for end in range(
                max(ayah, start + 1), min(max_ayah, start + max_span - 1) + 1
            ):
                span = make_span(db, surah, start, end)
                if span:
                    _add(out, seen, span)

    return out, base
