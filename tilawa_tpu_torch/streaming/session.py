"""RecitationSession — the live-recitation state machine, transport-free.

Behavioral port of the reference's WS endpoint logic (reference:
web/server.py:591-1032) restructured as a pure feed(samples) -> [messages]
class so it is unit-testable without sockets and reusable from the WS
server, benchmarks, and notebooks.

Two modes:

  DISCOVERY (2 s trigger, 10 s rolling window): transcribe → residual
  prefix strip vs last emitted verse (skip at >0.70 overlap) → match_verse
  (threshold 0.25, span 4, continuation hint, 5 runners-up) → lexical
  rerank of ambiguous matches → commit rules (repeat-confirmed x2 OR
  strong-first [gap >= 0.05] OR strong-continuation [expected next verse,
  score >= 0.65 / 0.80-long, gap >= 0.05]) with first-lock threshold 0.75
  vs 0.45 after → verse_match, else raw_transcript.

  TRACKING (0.5 s trigger, 5 s window): greedy forward word alignment with
  lookahead 5 resuming from last position → word_progress; verse complete
  at coverage >= 0.8 and within 2 words of the end; stale exit after 4
  no-progress cycles with misidentification rollback (progress < 50%) or
  residual-text trim; 4 s silence timeout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tilawa_tpu_torch.data.normalizer import normalize_arabic
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.text.levenshtein import partial_ratio, ratio

SAMPLE_RATE = 16000
TRIGGER_SAMPLES = SAMPLE_RATE * 2
MAX_WINDOW_SAMPLES = SAMPLE_RATE * 10
SILENCE_RMS_THRESHOLD = 0.005

VERSE_MATCH_THRESHOLD = 0.45
FIRST_MATCH_THRESHOLD = 0.75
RAW_TRANSCRIPT_THRESHOLD = 0.25
SURROUNDING_CONTEXT = 2
CONTINUATION_STRONG_THRESHOLD = 0.65
LONG_VERSE_CONTINUATION_THRESHOLD = 0.80
AMBIGUOUS_MATCH_GAP = 0.05
LEXICAL_RERANK_MIN_WORDS = 5
LEXICAL_RERANK_SCORE_GAP = 0.15
LEXICAL_RERANK_SWITCH_MARGIN = 0.03
WORD_MATCH_THRESHOLD = 0.72
LONG_TRACKING_WORD_THRESHOLD = 20
LONG_TRACKING_MIN_MATCHED_WORDS = 3

TRACKING_TRIGGER_SAMPLES = SAMPLE_RATE // 2
TRACKING_SILENCE_SAMPLES = SAMPLE_RATE * 4
TRACKING_MAX_WINDOW_SAMPLES = SAMPLE_RATE * 5
STALE_CYCLE_LIMIT = 4
ALIGN_LOOKAHEAD = 5


def is_silence(audio: np.ndarray) -> bool:
    if len(audio) == 0:
        return True
    return float(np.sqrt(np.mean(audio**2))) < SILENCE_RMS_THRESHOLD


def words_match(w1: str, w2: str, threshold: float = 0.7) -> bool:
    return ratio(w1, w2) >= threshold


def align_position(
    recognized_words: list[str],
    verse_words: list[str],
    start_from: int = 0,
) -> tuple[int, list[int]]:
    """Greedy forward word alignment with bounded lookahead (reference:
    server.py:484-525). Returns (furthest position + 1, matched indices)."""
    if not recognized_words or not verse_words:
        return 0, []
    matched: list[int] = []
    ptr = start_from
    for rec in recognized_words:
        if ptr >= len(verse_words):
            break
        limit = min(ptr + ALIGN_LOOKAHEAD, len(verse_words))
        for j in range(ptr, limit):
            if words_match(rec, verse_words[j]):
                matched.append(j)
                ptr = j + 1
                break
    if matched:
        return matched[-1] + 1, matched
    return start_from, []


def strip_leading_residual(
    text: str, previous_text: str, min_score: float = 0.82
) -> tuple[str, float]:
    """Trim a leading copy of the previously emitted verse (reference:
    server.py:528-559)."""
    text_words = text.split()
    prev_words = previous_text.split()
    if len(text_words) < 2 or len(prev_words) < 2:
        return "", 0.0
    best_score, best_k = 0.0, 0
    min_k = max(1, len(prev_words) - 1)
    max_k = min(len(text_words) - 1, len(prev_words) + 1)
    for k in range(min_k, max_k + 1):
        score = ratio(" ".join(text_words[:k]), previous_text)
        if score > best_score:
            best_score, best_k = score, k
    if best_score < min_score:
        return "", best_score
    return " ".join(text_words[best_k:]).strip(), best_score


def lexical_candidate_score(query_text: str, candidate_text: str) -> float:
    """Word-coverage blend used to re-rank ambiguous matches (reference:
    server.py:368-405)."""
    query_words = normalize_arabic(query_text).split()
    cand_words = normalize_arabic(candidate_text).split()
    if not query_words or not cand_words:
        return 0.0
    matched = 0
    pos = 0
    for qw in query_words:
        for idx in range(pos, len(cand_words)):
            if words_match(qw, cand_words[idx], WORD_MATCH_THRESHOLD):
                matched += 1
                pos = idx + 1
                break
    prefix_matches = 0
    for qw, cw in zip(query_words, cand_words):
        if words_match(qw, cw, WORD_MATCH_THRESHOLD):
            prefix_matches += 1
        else:
            break
    coverage = matched / max(min(len(query_words), len(cand_words)), 1)
    prefix_score = prefix_matches / max(min(3, len(query_words), len(cand_words)), 1)
    length_fit = min(len(query_words), len(cand_words)) / max(
        len(query_words), len(cand_words)
    )
    leftover = max(len(query_words) - matched, 0) / max(len(query_words), 1)
    lexical = 0.60 * coverage + 0.25 * prefix_score + 0.15 * length_fit - 0.15 * leftover
    return max(0.0, min(1.0, lexical))


def _match_key(match: dict) -> str:
    return f"{match['surah']}:{match['ayah']}:{match.get('ayah_end') or ''}"


def _runner_up_gap(match: dict) -> float:
    runners = [
        r for r in match.get("runners_up", []) if _match_key(r) != _match_key(match)
    ]
    if not runners:
        return 1.0
    return max(0.0, match["score"] - runners[0]["score"])


@dataclass
class SessionConfig:
    verse_match_threshold: float = VERSE_MATCH_THRESHOLD
    first_match_threshold: float = FIRST_MATCH_THRESHOLD
    raw_transcript_threshold: float = RAW_TRANSCRIPT_THRESHOLD
    max_span: int = 4


@dataclass
class _TrackingState:
    verse: dict | None = None
    words: list[str] = field(default_factory=list)
    last_word_idx: int = -1
    silence_samples: int = 0
    stale_cycles: int = 0


class RecitationSession:
    """feed(float32 samples) -> list of message dicts
    ({type: verse_match | word_progress | raw_transcript, ...})."""

    def __init__(
        self,
        transcribe,                      # (np.ndarray) -> str
        db: QuranDB | None = None,
        config: SessionConfig | None = None,
    ):
        self.transcribe = transcribe
        self.db = db or QuranDB()
        self.config = config or SessionConfig()
        self.audio = np.zeros(0, dtype=np.float32)
        self.new_audio = 0
        self.last_emitted_ref: tuple[int, int] | None = None
        self.last_emitted_text = ""
        self._prev_emitted_ref: tuple[int, int] | None = None
        self._prev_emitted_text = ""
        self._pending_key: str | None = None
        self._pending_count = 0
        self._tracking = _TrackingState()

    # ------------------------------------------------------------------ API

    @property
    def in_tracking(self) -> bool:
        return self._tracking.verse is not None

    def feed(self, samples: np.ndarray) -> list[dict]:
        samples = np.asarray(samples, dtype=np.float32)
        self.audio = np.concatenate([self.audio, samples])
        max_window = (
            TRACKING_MAX_WINDOW_SAMPLES if self.in_tracking else MAX_WINDOW_SAMPLES
        )
        if len(self.audio) > max_window:
            self.audio = self.audio[-max_window:]
        self.new_audio += len(samples)

        if self.in_tracking:
            return self._tracking_cycle(samples)
        return self._discovery_cycle()

    # ------------------------------------------------------------- tracking

    def _enter_tracking(self, verse: dict) -> None:
        self._tracking = _TrackingState(
            verse=verse, words=verse["text_clean"].split()
        )

    def _exit_tracking(self, reason: str) -> None:
        t = self._tracking
        verse_len = len(t.words)
        progress = (t.last_word_idx + 1) / verse_len if verse_len else 0.0
        long_tracking = (
            reason.startswith("stale") and verse_len >= LONG_TRACKING_WORD_THRESHOLD
        )
        if reason == "verse complete":
            pass
        elif reason.startswith("stale") and progress < 0.5 and not long_tracking:
            # Likely misidentification — revert to pre-tracking state.
            self.last_emitted_ref = self._prev_emitted_ref
            self.last_emitted_text = self._prev_emitted_text
        elif reason.startswith("stale") and long_tracking and t.last_word_idx < 0:
            pass  # long-verse lock retained
        elif reason.startswith("stale") and t.words and t.last_word_idx >= 0:
            # Partial progress: trim residual text to the tracked portion.
            self.last_emitted_text = " ".join(t.words[: t.last_word_idx + 1])
        self._tracking = _TrackingState()

    def _tracking_cycle(self, samples: np.ndarray) -> list[dict]:
        t = self._tracking
        if is_silence(samples):
            t.silence_samples += len(samples)
            if t.silence_samples >= TRACKING_SILENCE_SAMPLES:
                self._exit_tracking("extended silence")
                self.new_audio = 0
                return []
        else:
            t.silence_samples = 0

        if self.new_audio < TRACKING_TRIGGER_SAMPLES:
            return []
        self.new_audio = 0

        text = self.transcribe(self.audio.copy())
        if not text or len(text.strip()) < 3:
            return []
        recognized = text.split()

        resume_from = max(t.last_word_idx, 0)
        word_pos, matched = align_position(recognized, t.words, resume_from)

        advanced = bool(matched) and matched[-1] > t.last_word_idx
        out: list[dict] = []
        if not advanced:
            t.stale_cycles += 1
            if t.stale_cycles >= STALE_CYCLE_LIMIT:
                self._exit_tracking(f"stale ({t.stale_cycles} cycles)")
                self.new_audio = 0
                return []
        else:
            t.stale_cycles = 0
            t.last_word_idx = matched[-1]
            out.append(
                {
                    "type": "word_progress",
                    "surah": t.verse["surah"],
                    "ayah": t.verse["ayah"],
                    "word_index": word_pos,
                    "total_words": len(t.words),
                    "matched_indices": matched,
                }
            )

        if matched:
            coverage = len(matched) / len(t.words)
            near_end = matched[-1] >= len(t.words) - 2
            if coverage >= 0.8 and near_end:
                self.last_emitted_ref = (t.verse["surah"], t.verse["ayah"])
                self.last_emitted_text = normalize_arabic(t.verse["text_clean"])
                self._exit_tracking("verse complete")
                keep = min(len(self.audio), TRIGGER_SAMPLES)
                self.audio = self.audio[-keep:].copy()
        return out

    # ------------------------------------------------------------ discovery

    def _discovery_cycle(self) -> list[dict]:
        if self.new_audio < TRIGGER_SAMPLES:
            return []
        self.new_audio = 0

        if is_silence(self.audio[-TRIGGER_SAMPLES:]):
            return []

        text = self.transcribe(self.audio.copy())
        if not text or len(text.strip()) < 5:
            return []

        query_text = text
        if self.last_emitted_text:
            residual = partial_ratio(text, self.last_emitted_text)
            stripped, _score = strip_leading_residual(text, self.last_emitted_text)
            if stripped and len(stripped.split()) >= 2:
                query_text = stripped
            elif residual > 0.70:
                return []

        match = self.db.match_verse(
            query_text,
            threshold=self.config.raw_transcript_threshold,
            max_span=self.config.max_span,
            hint=self.last_emitted_ref,
            return_top_k=5,
            seeded_spans=True,
        )
        match = self._rerank_ambiguous(query_text, match)

        if match:
            key = _match_key(match)
            if self._pending_key == key:
                self._pending_count += 1
            else:
                self._pending_key = key
                self._pending_count = 1
        else:
            self._pending_key = None
            self._pending_count = 0
            return []

        effective_threshold = (
            self.config.first_match_threshold
            if self.last_emitted_ref is None
            else self.config.verse_match_threshold
        )
        gap = _runner_up_gap(match)
        repeat_confirmed = self._pending_count >= 2
        followup = self._is_expected_followup(match)
        continuation_threshold = (
            LONG_VERSE_CONTINUATION_THRESHOLD
            if self._is_long_verse(self.last_emitted_ref)
            else CONTINUATION_STRONG_THRESHOLD
        )
        strong_continuation = (
            followup and match["score"] >= continuation_threshold
            and gap >= AMBIGUOUS_MATCH_GAP
        )
        strong_first = self.last_emitted_ref is None and gap >= AMBIGUOUS_MATCH_GAP

        should_commit = match["score"] >= effective_threshold and (
            repeat_confirmed
            or strong_first
            or (self.last_emitted_ref is not None and strong_continuation)
        )

        if not should_commit:
            return [
                {
                    "type": "raw_transcript",
                    "text": text,
                    "confidence": round(match["score"], 2),
                }
            ]

        ref = (match["surah"], match["ayah"])
        if ref == self.last_emitted_ref:
            return []

        verse = self.db.get_verse(*ref)
        ayah_end = match.get("ayah_end")
        message = {
            "type": "verse_match",
            "surah": match["surah"],
            "ayah": match["ayah"],
            "ayah_end": ayah_end,
            "verse_text": verse["text_uthmani"] if verse else match.get("text", ""),
            "surah_name": verse.get("surah_name", "") if verse else "",
            "confidence": round(match["score"], 2),
            "surrounding_verses": self._surrounding(match["surah"], match["ayah"]),
        }

        self._prev_emitted_ref = self.last_emitted_ref
        self._prev_emitted_text = self.last_emitted_text
        self.last_emitted_ref = (match["surah"], ayah_end) if ayah_end else ref
        self.last_emitted_text = normalize_arabic(match.get("text_clean", "") or
                                                  (verse["text_clean"] if verse else ""))
        self._pending_key = None
        self._pending_count = 0

        if verse:
            self._enter_tracking(verse)
        else:
            self.audio = self.audio[-TRIGGER_SAMPLES:].copy()
        return [message]

    # -------------------------------------------------------------- helpers

    def _surrounding(self, surah: int, ayah: int) -> list[dict]:
        out = []
        for a in range(ayah - SURROUNDING_CONTEXT, ayah + SURROUNDING_CONTEXT + 1):
            v = self.db.get_verse(surah, a)
            if v:
                out.append(
                    {"surah": v["surah"], "ayah": v["ayah"],
                     "text": v["text_uthmani"], "is_current": a == ayah}
                )
        return out

    def _is_expected_followup(self, match: dict | None) -> bool:
        if not match or not self.last_emitted_ref:
            return False
        nv = self.db.get_next_verse(*self.last_emitted_ref)
        return bool(
            nv and nv["surah"] == match["surah"] and nv["ayah"] == match["ayah"]
        )

    def _is_long_verse(self, ref: tuple[int, int] | None) -> bool:
        if not ref:
            return False
        verse = self.db.get_verse(*ref)
        return bool(
            verse
            and len(verse["text_clean"].split()) >= LONG_TRACKING_WORD_THRESHOLD
        )

    def _rerank_ambiguous(self, query_text: str, match: dict | None) -> dict | None:
        if not match or len(query_text.split()) < LEXICAL_RERANK_MIN_WORDS:
            return match
        runners = match.get("runners_up", [])
        if not runners:
            return match
        current_key = _match_key(match)
        candidates = [dict(match)]
        for r in runners:
            if match["score"] - r["score"] > LEXICAL_RERANK_SCORE_GAP:
                continue
            candidates.append(
                {
                    "surah": r["surah"], "ayah": r["ayah"],
                    "ayah_end": r.get("ayah_end"), "score": r["score"],
                    "raw_score": r["raw_score"], "bonus": r["bonus"],
                }
            )
        if len(candidates) < 2:
            return match
        ranked = []
        for cand in candidates:
            if _match_key(cand) == current_key:
                cand_text = match.get("text_clean") or self._cand_text(cand)
            else:
                cand_text = self._cand_text(cand)
            lexical = lexical_candidate_score(query_text, cand_text)
            ranked.append((0.55 * cand["score"] + 0.45 * lexical, cand))
        ranked.sort(key=lambda x: x[0], reverse=True)
        current_combined = next(
            c for c, cand in ranked if _match_key(cand) == current_key
        )
        best_combined, best = ranked[0]
        if _match_key(best) == current_key:
            return match
        if best_combined < current_combined + LEXICAL_RERANK_SWITCH_MARGIN:
            return match
        out = dict(best)
        out["text_clean"] = self._cand_text(best)
        out["runners_up"] = runners
        return out

    def _cand_text(self, cand: dict) -> str:
        end = cand.get("ayah_end") or cand["ayah"]
        return self.db.span_text(cand["surah"], cand["ayah"], end) or ""
