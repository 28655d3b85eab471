"""VerseTracker — streaming text → verse-boundary emitter.

Behavioral parity with the reference tracker (reference:
shared/verse_tracker.py): prefix-aware scoring with a 0.7/0.3 prefix/full
blend switched at 0.8 coverage, continuation bonus +0.15 for the expected
next verse, peak-score-drop emission (threshold 0.15), overflow
split-and-recurse at 1.15x, and streaming-mode gates (min 2 words, min emit
score 0.4 vs 0.3 batch).

The corpus-wide scoring pass uses batched native ratio scans against
precomputed full-verse and word-prefix corpora rather than a per-verse
Python loop.
"""

from __future__ import annotations

import numpy as np

from tilawa_tpu_torch.data.normalizer import normalize_arabic
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.text.levenshtein import Corpus, ratio

CONTINUATION_BONUS = 0.15
SCORE_DROP_THRESHOLD = 0.15
MIN_EMIT_SCORE = 0.3
OVERFLOW_RATIO = 1.15
STREAMING_MIN_EMIT_SCORE = 0.4
MIN_WORDS_FOR_MATCH = 2


class _ScoringIndex:
    """Shared per-DB scoring structures (verse texts, word lists, prefix
    corpora cache) — built once, reused across tracker instances."""

    _instances: dict[int, "_ScoringIndex"] = {}

    def __init__(self, db: QuranDB):
        self.db = db
        self.words: list[list[str]] = [v["text_clean"].split() for v in db.verses]
        self.n_words = np.array([len(w) for w in self.words], dtype=np.int32)
        self.full_corpus = Corpus([v["text_clean"] for v in db.verses])
        self.no_bsm_idx = [
            i for i, v in enumerate(db.verses) if v["text_clean_no_bsm"]
        ]
        self.no_bsm_corpus = Corpus(
            [db.verses[i]["text_clean_no_bsm"] for i in self.no_bsm_idx]
        )
        self.no_bsm_words = [
            db.verses[i]["text_clean_no_bsm"].split() for i in self.no_bsm_idx
        ]
        # prefix corpora keyed by word count
        self._prefix_cache: dict[int, Corpus] = {}
        self._prefix_cache_no_bsm: dict[int, Corpus] = {}

    @classmethod
    def for_db(cls, db: QuranDB) -> "_ScoringIndex":
        key = id(db)
        if key not in cls._instances:
            cls._instances[key] = cls(db)
        return cls._instances[key]

    def prefix_corpus(self, n: int) -> Corpus:
        c = self._prefix_cache.get(n)
        if c is None:
            c = Corpus([" ".join(w[:n]) for w in self.words])
            self._prefix_cache[n] = c
        return c

    def prefix_corpus_no_bsm(self, n: int) -> Corpus:
        c = self._prefix_cache_no_bsm.get(n)
        if c is None:
            c = Corpus([" ".join(w[:n]) for w in self.no_bsm_words])
            self._prefix_cache_no_bsm[n] = c
        return c


class VerseTracker:
    """Track and emit verse detections from streaming text."""

    def __init__(
        self,
        db: QuranDB | None = None,
        last_emission: tuple[int, int] | None = None,
        streaming_mode: bool = False,
    ):
        self.db = db or QuranDB()
        self._index = _ScoringIndex.for_db(self.db)
        self._streaming_mode = streaming_mode
        self._min_emit_score = (
            STREAMING_MIN_EMIT_SCORE if streaming_mode else MIN_EMIT_SCORE
        )
        self._accumulated = ""
        self._current_match: dict | None = None
        self._peak_score = 0.0
        self._emissions: list[dict] = []
        self._last_emitted = last_emission

    # ------------------------------------------------------------- scoring

    def _batch_scores(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized _score_verse over all verses; returns (scores, is_no_bsm)
        where is_no_bsm marks rows whose winning text was the
        bismillah-stripped variant."""
        idx = self._index
        n_text = len(text.split())

        def blended(full: np.ndarray, prefix: np.ndarray, n_verse: np.ndarray):
            coverage = n_text / np.maximum(n_verse, 1)
            return np.where(
                coverage > 0.8,
                0.3 * prefix + 0.7 * full,
                0.7 * prefix + 0.3 * full,
            )

        full = idx.full_corpus.batch_ratio(text)
        # Prefix ratio compares against the first min(n_text, n_verse) words:
        # for verses shorter than the query that prefix IS the full text.
        short_mask = idx.n_words <= n_text
        prefix = np.where(short_mask, full, 0.0)
        if (~short_mask).any():
            pc = idx.prefix_corpus(n_text)
            pr = pc.batch_ratio(text)
            prefix = np.where(~short_mask, pr, prefix)
        scores = blended(full, prefix, idx.n_words)

        is_no_bsm = np.zeros(len(scores), dtype=bool)
        if idx.no_bsm_idx:
            nb_words = np.array([len(w) for w in idx.no_bsm_words], dtype=np.int32)
            nb_full = idx.no_bsm_corpus.batch_ratio(text)
            nb_short = nb_words <= n_text
            nb_prefix = np.where(nb_short, nb_full, 0.0)
            if (~nb_short).any():
                pc = idx.prefix_corpus_no_bsm(n_text)
                nb_prefix = np.where(~nb_short, pc.batch_ratio(text), nb_prefix)
            nb_scores = blended(nb_full, nb_prefix, nb_words)
            rows = np.array(idx.no_bsm_idx)
            better = nb_scores > scores[rows]
            scores[rows] = np.where(better, nb_scores, scores[rows])
            is_no_bsm[rows[better]] = True

        # Continuation bias
        if self._last_emitted:
            nv = self.db.get_next_verse(*self._last_emitted)
            if nv:
                i = self.db._ref_to_idx[(nv["surah"], nv["ayah"])]
                scores[i] += CONTINUATION_BONUS
        return scores, is_no_bsm

    def _find_best_match(self, text: str) -> dict | None:
        if not text.strip():
            return None
        if self._streaming_mode and len(text.split()) < MIN_WORDS_FOR_MATCH:
            return None
        scores, is_no_bsm = self._batch_scores(text)
        i = int(scores.argmax())
        best_score = float(scores[i])
        if best_score < self._min_emit_score:
            return None
        v = self.db.verses[i]
        matched_text = (
            v["text_clean_no_bsm"] if is_no_bsm[i] else v["text_clean"]
        )
        return {
            "surah": v["surah"],
            "ayah": v["ayah"],
            "text_clean": matched_text,
            "score": best_score,
        }

    # ------------------------------------------------------------ emission

    def _emit(self, match: dict) -> dict | None:
        matched_words = match["text_clean"].split()
        acc_words = self._accumulated.split()
        overlap = min(len(matched_words), len(acc_words))
        self._accumulated = " ".join(acc_words[overlap:])

        self._current_match = None
        self._peak_score = 0.0

        ref = (match["surah"], match["ayah"])
        if ref == self._last_emitted:
            return None
        emission = {
            "surah": match["surah"], "ayah": match["ayah"], "score": match["score"]
        }
        self._emissions.append(emission)
        self._last_emitted = ref
        return emission

    def _try_split_and_emit(self, match: dict) -> list[dict]:
        emissions: list[dict] = []
        acc_words = self._accumulated.split()
        verse_words = match["text_clean"].split()
        if len(acc_words) > len(verse_words) * OVERFLOW_RATIO and verse_words:
            e = self._emit(match)
            if e:
                emissions.append(e)
            if self._accumulated.strip():
                nxt = self._find_best_match(self._accumulated)
                if nxt:
                    more = self._try_split_and_emit(nxt)
                    if more:
                        emissions.extend(more)
                    else:
                        self._current_match = nxt
                        self._peak_score = nxt["score"]
        return emissions

    def _evaluate(self) -> list[dict]:
        emissions: list[dict] = []
        match = self._find_best_match(self._accumulated)
        if not match:
            return []

        same_verse = (
            self._current_match
            and self._current_match["surah"] == match["surah"]
            and self._current_match["ayah"] == match["ayah"]
        )

        if same_verse:
            if match["score"] > self._peak_score:
                self._peak_score = match["score"]
            elif self._peak_score - match["score"] > SCORE_DROP_THRESHOLD:
                e = self._emit(self._current_match)
                if e:
                    emissions.append(e)
                if self._accumulated.strip():
                    nxt = self._find_best_match(self._accumulated)
                    if nxt:
                        self._current_match = nxt
                        self._peak_score = nxt["score"]
                    else:
                        self._current_match = None
                        self._peak_score = 0.0
            else:
                self._current_match = match
        else:
            if self._current_match and self._current_match["score"] >= self._min_emit_score:
                e = self._emit(self._current_match)
                if e:
                    emissions.append(e)
            self._current_match = match
            self._peak_score = match["score"]

        if not self._current_match:
            self._current_match = match
            self._peak_score = match["score"]

        if self._current_match and not emissions:
            split = self._try_split_and_emit(self._current_match)
            if split:
                emissions.extend(split)
        return emissions

    # -------------------------------------------------------------- public

    def process_text(self, text: str) -> list[dict]:
        """Full accumulated transcript snapshot → emissions."""
        normalized = normalize_arabic(text)
        if not normalized.strip():
            return []
        self._accumulated = normalized
        return self._evaluate()

    def process_delta(self, new_text: str) -> list[dict]:
        """Append a transcript delta → emissions."""
        normalized = normalize_arabic(new_text)
        if not normalized.strip():
            return []
        self._accumulated = (
            f"{self._accumulated} {normalized}" if self._accumulated else normalized
        )
        return self._evaluate()

    def finalize(self) -> list[dict]:
        if self._current_match and self._current_match["score"] >= self._min_emit_score:
            e = self._emit(self._current_match)
            return [e] if e else []
        return []
