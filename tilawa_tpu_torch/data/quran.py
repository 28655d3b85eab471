"""Quran verse store + fuzzy retrieval.

Behavioral parity with the reference engine (reference: shared/quran_db.py —
verse store lines 39-90, trigram index 151-186, continuation bonuses 121-142,
fragment/suffix-prefix scoring 188-237, two-pass match_verse 244-371), built
TPU-framework-style: every corpus-wide scoring pass is one batched native
edit-distance scan (tilawa_tpu_torch.text.levenshtein.Corpus) instead of a
per-verse Python loop, and span texts are cached per (surah, span) so the
multi-ayah pass is also a single batched scan per surah.

Scoring semantics preserved exactly:
  * ratio() is python-Levenshtein-compatible (indel / LCS based)
  * fragment scoring blends partial_ratio at 0.75 with a shorter-verse
    penalty; exact interior substrings of >=3 words score >= 0.98
  * continuation bonuses +0.22/+0.12/+0.06 for the 1st/2nd/3rd expected
    next verse (wrapping into the next surah at surah end)
  * suffix-prefix scoring slides up to 4 residual words off the front of
    the query for continuation candidates
  * span pass enumerates 2..max_span consecutive-ayah windows inside the
    top-20 candidate surahs, bismillah-stripped on the first verse
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from pathlib import Path

import numpy as np

from tilawa_tpu_torch.data.assets import default_asset_path
from tilawa_tpu_torch.data.normalizer import normalize_arabic
from tilawa_tpu_torch.text import levenshtein as lev
from tilawa_tpu_torch.text.levenshtein import Corpus, partial_ratio, ratio

BISMILLAH_CLEAN = normalize_arabic("بسم الله الرحمن الرحيم")

_CONT_BONUSES = (0.22, 0.12, 0.06)


def _fragment_blend(text: str, verse_text: str, full_ratio: float,
                    frag: float | None = None) -> float:
    """Blend a full-string ratio with partial (windowed) matching for long
    queries against longer verses (reference: shared/quran_db.py:212-237)."""
    query_words = text.split()
    verse_words = verse_text.split()
    if len(query_words) >= 3 and f" {text} " in f" {verse_text} ":
        return max(full_ratio, 0.98)
    if len(query_words) < 4 or len(verse_words) < 2:
        return full_ratio
    if frag is None:
        frag = partial_ratio(text, verse_text)
    if frag <= full_ratio:
        return full_ratio
    shorter_penalty = min(1.0, len(verse_words) / max(len(query_words), 1))
    blended = 0.25 * full_ratio + 0.75 * frag * shorter_penalty
    return max(full_ratio, blended)


def _suffix_prefix_score(text: str, verse_text: str) -> float:
    """Best ratio of query-suffixes vs equal-word-count verse prefixes —
    recovers continuation matches when residual words from the previous
    verse lead the window (reference: shared/quran_db.py:188-209)."""
    words_t = text.split()
    words_v = verse_text.split()
    if len(words_t) < 2 or len(words_v) < 2:
        return 0.0
    best = 0.0
    for trim in range(1, min(len(words_t) // 2, 4) + 1):
        suffix = " ".join(words_t[trim:])
        n = len(words_t) - trim
        prefix = " ".join(words_v[: min(n, len(words_v))])
        best = max(best, ratio(suffix, prefix))
    return best


def _char_trigrams(text: str) -> set[str]:
    return {text[i : i + 3] for i in range(len(text) - 2)} if len(text) >= 3 else set()


class QuranDB:
    """Verse store with trigram-indexed fuzzy retrieval over 6,236 verses."""

    def __init__(self, path: str | Path | None = None):
        path = Path(path) if path else default_asset_path("quran.json")
        with open(path, encoding="utf-8") as f:
            self.verses: list[dict] = json.load(f)

        self._by_ref: dict[tuple[int, int], dict] = {}
        self._by_surah: dict[int, list[dict]] = {}
        for v in self.verses:
            v["text_clean"] = v["text_clean"].lstrip("﻿")
            v["text_clean_alt"] = normalize_arabic(v["text_uthmani"]).lstrip("﻿")
            self._by_ref[(v["surah"], v["ayah"])] = v
            self._by_surah.setdefault(v["surah"], []).append(v)
            no_bsm = None
            if (
                v["ayah"] == 1
                and v["surah"] not in (1, 9)
                and v["text_clean"].startswith(BISMILLAH_CLEAN)
            ):
                stripped = v["text_clean"][len(BISMILLAH_CLEAN) :].strip()
                no_bsm = stripped or None
            v["text_clean_no_bsm"] = no_bsm

        self._ref_to_idx = {
            (v["surah"], v["ayah"]): i for i, v in enumerate(self.verses)
        }

        # Pre-encoded corpora for batched native scans.
        self._corpus_clean = Corpus([v["text_clean"] for v in self.verses])
        self._corpus_alt = Corpus([v["text_clean_alt"] for v in self.verses])
        self._corpus_spaceless = Corpus(
            [v["text_clean"].replace(" ", "") for v in self.verses]
        )
        self._word_counts = np.array(
            [len(v["text_clean"].split()) for v in self.verses], dtype=np.int32
        )
        self._word_counts_alt = np.array(
            [len(v["text_clean_alt"].split()) for v in self.verses], dtype=np.int32
        )

        # Span-text caches: (surah, span_len) -> (texts Corpus, start ayahs).
        self._span_cache: dict[tuple[int, int], tuple[Corpus, list[int]]] = {}
        self._global_span_cache: dict[int, tuple] = {}

        self._build_trigram_index()

    # ------------------------------------------------------------- accessors

    @property
    def total_verses(self) -> int:
        return len(self.verses)

    @property
    def surah_count(self) -> int:
        return len(self._by_surah)

    def get_verse(self, surah: int, ayah: int) -> dict | None:
        return self._by_ref.get((surah, ayah))

    def get_surah(self, surah: int) -> list[dict]:
        return self._by_surah.get(surah, [])

    def get_next_verse(self, surah: int, ayah: int) -> dict | None:
        """Next verse after surah:ayah, wrapping to the next surah."""
        verses = self._by_surah.get(surah, [])
        for i, v in enumerate(verses):
            if v["ayah"] == ayah:
                if i + 1 < len(verses):
                    return verses[i + 1]
                nxt = self._by_surah.get(surah + 1, [])
                return nxt[0] if nxt else None
        return None

    # --------------------------------------------------------- trigram index

    def _build_trigram_index(self) -> None:
        posting: dict[str, set[int]] = defaultdict(set)
        n = len(self.verses)
        for idx, v in enumerate(self.verses):
            tris = _char_trigrams(v["text_clean"]) | _char_trigrams(v["text_clean_alt"])
            if v["text_clean_no_bsm"]:
                tris |= _char_trigrams(v["text_clean_no_bsm"])
            for tri in tris:
                posting[tri].add(idx)
        self._trigram_index: dict[str, np.ndarray] = {}
        self._idf: dict[str, float] = {}
        for tri, indices in posting.items():
            self._trigram_index[tri] = np.fromiter(
                sorted(indices), dtype=np.int32, count=len(indices)
            )
            self._idf[tri] = math.log(n / len(indices))

    def trigram_candidates(self, text: str, top_k: int = 50) -> list[int]:
        """Top-k verse indices by IDF-weighted trigram overlap."""
        trigrams = _char_trigrams(text)
        if not trigrams:
            return []
        scores = np.zeros(len(self.verses), dtype=np.float64)
        hit = np.zeros(len(self.verses), dtype=bool)
        for tri in trigrams:
            w = self._idf.get(tri)
            if w is None:
                continue
            idxs = self._trigram_index[tri]
            scores[idxs] += w
            hit[idxs] = True
        cand = np.nonzero(hit)[0]
        if cand.size == 0:
            return []
        order = cand[np.argsort(-scores[cand], kind="stable")]
        return order[:top_k].tolist()

    # ----------------------------------------------------------- span texts

    def _span_corpus(self, surah: int, span: int) -> tuple[Corpus, list[int]]:
        key = (surah, span)
        hit = self._span_cache.get(key)
        if hit is not None:
            return hit
        verses = self._by_surah[surah]
        texts, starts = [], []
        for i in range(len(verses) - span + 1):
            chunk = verses[i : i + span]
            first = chunk[0]["text_clean_no_bsm"] or chunk[0]["text_clean"]
            texts.append(" ".join([first] + [c["text_clean"] for c in chunk[1:]]))
            starts.append(chunk[0]["ayah"])
        entry = (Corpus(texts), starts)
        self._span_cache[key] = entry
        return entry

    def _global_span_corpus(
        self, span: int
    ) -> tuple[Corpus, np.ndarray, np.ndarray, dict[int, tuple[int, int]]]:
        """All span-`span` windows of every surah in one Corpus, with
        per-surah row ranges — lets match_verse score the span pass with
        one native subset scan per span size instead of one small ctypes
        call per surah (the dominant cost of a match_verse query)."""
        hit = self._global_span_cache.get(span)
        if hit is not None:
            return hit
        texts: list[str] = []
        surahs: list[int] = []
        starts: list[int] = []
        ranges: dict[int, tuple[int, int]] = {}
        for s in sorted(self._by_surah):
            verses = self._by_surah[s]
            r0 = len(texts)
            for i in range(len(verses) - span + 1):
                chunk = verses[i : i + span]
                first = chunk[0]["text_clean_no_bsm"] or chunk[0]["text_clean"]
                texts.append(
                    " ".join([first] + [c["text_clean"] for c in chunk[1:]])
                )
                surahs.append(s)
                starts.append(chunk[0]["ayah"])
            ranges[s] = (r0, len(texts))
        entry = (
            Corpus(texts),
            np.asarray(surahs, dtype=np.int64),
            np.asarray(starts, dtype=np.int64),
            ranges,
        )
        self._global_span_cache[span] = entry
        return entry

    def span_text(self, surah: int, start: int, end: int) -> str | None:
        """Combined clean text of verses surah:start..end (bismillah-stripped
        on the first), or None if any verse is missing."""
        chunk = [self.get_verse(surah, a) for a in range(start, end + 1)]
        if any(v is None for v in chunk):
            return None
        first = chunk[0]["text_clean_no_bsm"] or chunk[0]["text_clean"]
        return " ".join([first] + [v["text_clean"] for v in chunk[1:]])

    # -------------------------------------------------------------- scoring

    def _continuation_bonuses(
        self, hint: tuple[int, int] | None
    ) -> dict[tuple[int, int], float]:
        if not hint:
            return {}
        h_surah, h_ayah = hint
        bonuses: dict[tuple[int, int], float] = {}
        if (h_surah, h_ayah + 1) in self._by_ref:
            for step, bonus in enumerate(_CONT_BONUSES, start=1):
                if (h_surah, h_ayah + step) in self._by_ref:
                    bonuses[(h_surah, h_ayah + step)] = bonus
                else:
                    break
        else:
            for i, nv in enumerate(self._by_surah.get(h_surah + 1, [])[:3]):
                bonuses[(nv["surah"], nv["ayah"])] = _CONT_BONUSES[i]
        return bonuses

    def _batch_fragment_scores(
        self, text: str, top_k: int | None = None
    ) -> np.ndarray:
        """max over {text_clean, text_clean_alt} of the fragment-blended
        ratio, for every verse, via batched native scans.

        partial_ratio is computed only where it can change the result: the
        blend max(full, 0.25*full + 0.75*frag*penalty) with frag <= 1 can
        only beat `full` when penalty > full — an exact bound that prunes
        the expensive windowed scan. When `top_k` is given, rows whose
        optimistic bound (frag = 1) cannot beat the k-th best cheap score
        are skipped too — exact for top-k selection, since at least k rows
        already score >= that floor without the fragment term."""
        r_clean = self._corpus_clean.batch_ratio(text)
        r_alt = self._corpus_alt.batch_ratio(text)
        nq = len(text.split())
        p_clean = p_alt = None
        if nq >= 4:
            penalty = np.minimum(1.0, self._word_counts / max(nq, 1))
            penalty_alt = np.minimum(1.0, self._word_counts_alt / max(nq, 1))
            need_mask_c = (penalty > r_clean) & (self._word_counts >= 2)
            need_mask_a = (penalty_alt > r_alt) & (self._word_counts_alt >= 2)
            if top_k is not None:
                cheap = np.maximum(r_clean, r_alt)
                k = min(max(top_k, 1), len(cheap))
                floor = float(np.partition(cheap, -k)[-k]) - 1e-9
                # optimistic blend with frag = 1
                bound_c = 0.25 * r_clean + 0.75 * penalty
                bound_a = 0.25 * r_alt + 0.75 * penalty_alt
                need_mask_c &= bound_c > floor
                need_mask_a &= bound_a > floor
            need_c = np.nonzero(need_mask_c)[0]
            need_a = np.nonzero(need_mask_a)[0]
            p_clean = dict(
                zip(
                    need_c.tolist(),
                    self._corpus_clean.subset_partial_ratio(text, need_c).tolist(),
                )
            )
            p_alt = dict(
                zip(
                    need_a.tolist(),
                    self._corpus_alt.subset_partial_ratio(text, need_a).tolist(),
                )
            )
        out = np.empty(len(self.verses), dtype=np.float64)
        padded = f" {text} "
        for i, v in enumerate(self.verses):
            fc = self._blend_one(
                text, nq, v["text_clean"], int(self._word_counts[i]),
                r_clean[i], None if p_clean is None else p_clean.get(i), padded,
            )
            fa = self._blend_one(
                text, nq, v["text_clean_alt"], int(self._word_counts_alt[i]),
                r_alt[i], None if p_alt is None else p_alt.get(i), padded,
            )
            out[i] = fc if fc >= fa else fa
        return out

    @staticmethod
    def _blend_one(text: str, nq: int, verse_text: str, nv: int,
                   full_ratio: float, frag: float | None, padded: str) -> float:
        if nq >= 3 and padded in f" {verse_text} ":
            return max(full_ratio, 0.98)
        if nq < 4 or nv < 2 or frag is None:
            return full_ratio
        if frag <= full_ratio:
            return full_ratio
        shorter_penalty = min(1.0, nv / max(nq, 1))
        blended = 0.25 * full_ratio + 0.75 * frag * shorter_penalty
        return max(full_ratio, blended)

    def best_fragment_score(self, text: str, verse: dict) -> float:
        """Single-verse fragment score (max over clean/alt texts)."""
        return max(
            _fragment_blend(text, verse["text_clean"], ratio(text, verse["text_clean"])),
            _fragment_blend(
                text, verse["text_clean_alt"], ratio(text, verse["text_clean_alt"])
            ),
        )

    # -------------------------------------------------------------- search

    def search(self, text: str, top_k: int = 5) -> list[dict]:
        """Full-corpus fragment-score scan, top-k verses."""
        text = normalize_arabic(text)
        scores = self._batch_fragment_scores(text, top_k=top_k)
        order = np.argsort(-scores, kind="stable")[:top_k]
        return [
            {**self.verses[i], "score": float(scores[i]), "text": self.verses[i]["text_uthmani"]}
            for i in order
        ]

    def spaceless_scan(self, text: str, top_k: int = 100) -> list[dict]:
        """max(spaced ratio, spaceless ratio) full scan — catches BPE splits
        that drop inter-word spaces (reference: c2c-direct/run.py:284-297)."""
        spaceless = text.replace(" ", "")
        s1 = self._corpus_clean.batch_ratio(text)
        s2 = self._corpus_spaceless.batch_ratio(spaceless)
        scores = np.maximum(s1, s2)
        order = np.argsort(-scores, kind="stable")[:top_k]
        return [
            {**self.verses[i], "score": float(scores[i])} for i in order
        ]

    # ---------------------------------------------------------- match_verse

    def match_verse(
        self,
        text: str,
        threshold: float = 0.3,
        max_span: int = 3,
        hint: tuple[int, int] | None = None,
        return_top_k: int = 0,
        use_trigram_index: bool = False,
        seeded_spans: bool = False,
    ) -> dict | None:
        """Best-matching verse or consecutive-verse span.

        Two passes: single-verse scoring (optionally trigram-restricted with
        a full-scan fallback below 20 hits), then 2..max_span span windows
        inside the top-20 candidate surahs. Continuation *hint* adds bonuses
        and enables suffix-prefix rescue scoring.

        seeded_spans=True additionally (a) seeds the span pass with the top
        trigram candidates' surahs (a short opening verse like 103:1 is
        rank-897 by fragment score but rank-1 by trigram, and only its SPAN
        matches the query) and (b) completes a suffix-prefix winner into the
        hint..winner span. Both are measured tracker improvements; the
        default False path is score-exact with the reference
        (reference: shared/quran_db.py:244-371 spans only scored[:20]).
        """
        text = normalize_arabic(text)
        if not text.strip():
            return None

        bonuses = self._continuation_bonuses(hint)

        if use_trigram_index:
            candidate_idxs = set(self.trigram_candidates(text, top_k=50))
            for ref in bonuses:
                idx = self._ref_to_idx.get(ref)
                if idx is not None:
                    candidate_idxs.add(idx)
            if len(candidate_idxs) < 20:
                candidate_idxs = None  # full scan fallback
        else:
            candidate_idxs = None

        if candidate_idxs is None:
            raw_scores = self._batch_fragment_scores(text)
            idx_list = range(len(self.verses))
        else:
            idx_list = sorted(candidate_idxs)
            raw_scores = {}
            for i in idx_list:
                raw_scores[i] = self.best_fragment_score(text, self.verses[i])

        scored: list[tuple[dict, float, float, float]] = []
        for i in idx_list:
            v = self.verses[i]
            raw = float(raw_scores[i])
            if v["text_clean_no_bsm"]:
                stripped = _fragment_blend(
                    text, v["text_clean_no_bsm"], ratio(text, v["text_clean_no_bsm"])
                )
                raw = max(raw, stripped)
            bonus = bonuses.get((v["surah"], v["ayah"]), 0.0)
            if bonus > 0:
                sp = max(
                    _suffix_prefix_score(text, v["text_clean"]),
                    _suffix_prefix_score(text, v["text_clean_alt"]),
                )
                raw = max(raw, sp)
            scored.append((v, raw, bonus, min(raw + bonus, 1.0)))
        scored.sort(key=lambda x: x[3], reverse=True)

        best_v, best_raw, best_bonus, best_score = scored[0]
        best: dict = {
            **best_v,
            "score": best_score,
            "raw_score": best_raw,
            "bonus": best_bonus,
        }

        top_singles = [
            {
                "surah": v["surah"],
                "ayah": v["ayah"],
                "raw_score": round(raw, 3),
                "bonus": round(bon, 3),
                "score": round(total, 3),
                "text_clean": v["text_clean"][:60],
            }
            for v, raw, bon, total in scored[: max(return_top_k, 5)]
        ]

        # Pass 2: spans inside the top-20 candidate surahs (batched per
        # surah), plus the surahs of the top trigram candidates. The edit
        # ratio under-ranks a short opening verse when the query runs past
        # it into the next verse (measured: "والعصر ان الانسن" puts 103:1
        # at rank 897 by fragment score while the trigram index puts it
        # first — only the 103:1-2 SPAN matches well, and it is reachable
        # only if surah 103 enters this pass).
        span_surahs: list[int] = [v["surah"] for v, _r, _b, _t in scored[:20]]
        if seeded_spans:
            span_surahs.extend(
                self.verses[i]["surah"]
                for i in self.trigram_candidates(text, top_k=20)
            )
        ordered_surahs: list[int] = []
        seen_surahs: set[int] = set()
        for s in span_surahs:
            if s not in seen_surahs:
                seen_surahs.add(s)
                ordered_surahs.append(s)
        # One native subset scan per span SIZE over a global span corpus
        # (was: one scan per surah x span — ~100 small ctypes calls per
        # query dominated match_verse latency). Scores are identical; the
        # sequential strict-> update is reproduced by taking the max score
        # and breaking ties by the original (surah order, span, start)
        # iteration order.
        surah_pos = {s: i for i, s in enumerate(ordered_surahs)}
        span_best: tuple | None = None  # (score, order_key, payload)
        for span in range(2, max_span + 1):
            corpus, surahs_arr, starts_arr, ranges = self._global_span_corpus(span)
            idx_parts = [
                np.arange(*ranges[s])
                for s in ordered_surahs
                if s in ranges and ranges[s][1] > ranges[s][0]
            ]
            if not idx_parts:
                continue
            idxs = np.concatenate(idx_parts)
            ratios = corpus.subset_ratio(text, idxs)
            scores = ratios.copy()
            if bonuses:
                for j, gi in enumerate(idxs):
                    b = bonuses.get(
                        (int(surahs_arr[gi]), int(starts_arr[gi]))
                    )
                    if b:
                        scores[j] = min(scores[j] + b, 1.0)
            j_best = None
            for j in np.nonzero(scores > best_score)[0]:
                gi = int(idxs[j])
                key = (surah_pos[int(surahs_arr[gi])], span, gi)
                if j_best is None or (
                    scores[j] > scores[j_best[0]]
                    or (scores[j] == scores[j_best[0]] and key < j_best[1])
                ):
                    j_best = (int(j), key)
            if j_best is not None:
                j, key = j_best
                gi = int(idxs[j])
                cand = (float(scores[j]), key, gi, float(ratios[j]), span)
                if span_best is None or (
                    cand[0] > span_best[0]
                    or (cand[0] == span_best[0] and cand[1] < span_best[1])
                ):
                    span_best = cand
        if span_best is not None:
            score, _key, gi, raw, span = span_best
            corpus, surahs_arr, starts_arr, _ranges = self._global_span_corpus(span)
            s = int(surahs_arr[gi])
            start_ayah = int(starts_arr[gi])
            end_ayah = start_ayah + span - 1
            chunk = [
                self._by_ref[(s, a)] for a in range(start_ayah, end_ayah + 1)
            ]
            best_score = score
            best = {
                "surah": s,
                "ayah": start_ayah,
                "ayah_end": end_ayah,
                "text": " ".join(c["text_uthmani"] for c in chunk),
                "text_clean": corpus.texts[gi],
                "score": score,
                "raw_score": raw,
                "bonus": bonuses.get((s, start_ayah), 0.0),
            }

        # Span completion for suffix-prefix winners: with a continuation
        # hint, a query "full verse N+1 + head of N+2" lets the
        # suffix-prefix rescue crown N+2 alone at 1.0 (its head IS the
        # query's tail) while the true reading is the span N+1..N+2
        # (measured: "اله الناس من شر" after 114:2 → 114:4 at 1.0, dropping
        # 114:3). If the span from hint+1 to the winner is prefix-consistent
        # with the query, return the span.
        if (
            seeded_spans
            and hint
            and best.get("ayah_end") is None
            and best["surah"] == hint[0]
            and hint[1] + 1 < best["ayah"] <= hint[1] + max_span
        ):
            start = hint[1] + 1
            stext = self.span_text(best["surah"], start, best["ayah"])
            if stext and len(stext) >= len(text):
                pc = ratio(text, stext[: len(text)])
                if pc >= 0.9:
                    chunk = [
                        self._by_ref[(best["surah"], a)]
                        for a in range(start, best["ayah"] + 1)
                    ]
                    best = {
                        "surah": best["surah"],
                        "ayah": start,
                        "ayah_end": best["ayah"],
                        "text": " ".join(c["text_uthmani"] for c in chunk),
                        "text_clean": stext,
                        "score": max(best_score, pc),
                        "raw_score": pc,
                        "bonus": best.get("bonus", 0.0),
                    }
                    best_score = best["score"]

        if best_score >= threshold:
            if return_top_k > 0:
                best["runners_up"] = top_singles[:return_top_k]
            return best
        return None
