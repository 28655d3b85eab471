"""RecitationTracker — the full-featured streaming brain.

Behavioral parity with the reference's browser tracker (reference:
web/frontend/src/lib/tracker.ts, 1,928 LoC), rebuilt as host-side policy
around the TPU transcribe function:

  * discovery/tracking two-mode FSM with RMS silence gating and
    final-flush detection (tracker.ts:540-599)
  * candidate fusion ranking: text 0.6 / acoustic 0.25 / length 0.15,
    low-text 0.45/0.4/0.15 (types.ts:152-157, tracker.ts:1694-1777); the
    acoustic term is the batched on-device CTC forced-alignment scorer
  * commit rules: clear-margin (gated by decode stability ≥ 0.70,
    tracker.ts:188-195, 1424-1436) OR repeated leader OR final flush;
    anti-cascade blocks on non-continuation jumps (tracker.ts:1381-1415)
  * short-utterance CTC rescue over short-verse candidates
    (tracker.ts:1055-1110)
  * tracking: greedy word alignment with lookahead (tracker.ts:220-252),
    acoustic/char-level progress fallbacks, advance gate comparing CTC
    scores of current-verse suffix vs next-verse prefix
    (tracker.ts:857-877), deferred next-verse emission with pre-advance
    snapshot rollback (tracker.ts:907-1003, 1843-1860), stale exit and
    misidentification rollback
  * per-utterance StreamingHypothesis Viterbi over candidate cycles →
    final_sequence (tracker.ts:314-431)
  * typed diagnostics event stream via on_diagnostic (tracker.ts:90-173)

The acoustic backend is any callable returning a TranscribeResult; the
production one wraps the jitted FastConformer runtime, tests inject
synthetic/oracle backends (the reference's mocked-tracker pattern,
test/tracker-deferred.test.ts:1-17).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from tilawa_tpu_torch.data.quran import BISMILLAH_CLEAN, QuranDB
from tilawa_tpu_torch.data.token_store import TokenStore
from tilawa_tpu_torch.streaming.config import (
    DEFAULT_STREAMING_CONFIG,
    HypothesisParams,
    StreamingConfig,
    hypothesis_params_from_env,
)
from tilawa_tpu_torch.text.levenshtein import partial_ratio, ratio

SAMPLE_RATE = 16000

# Discovery constants (types.ts:137-157) that are not runtime knobs.
RAW_TRANSCRIPT_THRESHOLD = 0.25
SURROUNDING_CONTEXT = 2
DISCOVERY_TOP_SINGLE_CANDIDATES = 64
DISCOVERY_MAX_SPAN = 4
DISCOVERY_EXPANDED_CANDIDATES = 200
DISCOVERY_LOW_CONFIDENCE_WORDS = 4
DISCOVERY_LOW_CONFIDENCE_CHARS = 18
FUSION_TEXT_W, FUSION_ACOUSTIC_W, FUSION_LENGTH_W = 0.6, 0.25, 0.15
FUSION_LOW_TEXT_W, FUSION_LOW_ACOUSTIC_W, FUSION_LOW_LENGTH_W = 0.45, 0.4, 0.15
FUSION_SELECTION_GAP = 0.08
SHORT_VERSE_MAX_TOKENS = 15
# Minimum text-score lead over the best non-overlapping candidate before a
# live non-continuation commit; near-ties mean the transcript is still a
# shared prefix of several verses and more audio will disambiguate
# (reference: web/server.py:914-945 requires gap >= 0.05 for ambiguous
# strong-continuation commits; mid-verse ties are the same situation).
AMBIGUITY_GAP = 0.04


def _strip_bismillah(text: str) -> str:
    """Drop a leading bismillah; it opens every surah's with-bismillah
    variant and carries no verse-identity information."""
    if text.startswith(BISMILLAH_CLEAN):
        return text[len(BISMILLAH_CLEAN) :].strip()
    return text


def prefix_blend_score(text: str, cand_text: str, base: float) -> float:
    """Prefix-aware candidate score: mid-verse the query covers only the
    head of the true verse, so blend a prefix ratio with the full ratio,
    weighted by coverage (VerseTracker semantics, reference:
    shared/verse_tracker.py:40-65). Returns max(base, blend)."""
    qw = text.split()
    n_q = len(qw)
    cw = cand_text.split()
    if n_q < 3 or len(cw) <= n_q:
        return base
    full_r = ratio(text, cand_text)
    pref_r = ratio(text, " ".join(cw[:n_q]))
    coverage = n_q / len(cw)
    if coverage > 0.8:
        blended = 0.3 * pref_r + 0.7 * full_r
    else:
        blended = 0.7 * pref_r + 0.3 * full_r
    return max(base, blended)


@dataclasses.dataclass
class TranscribeResult:
    """One acoustic decode of the current window."""

    text: str                      # normalized transcript
    token_ids: list[int] = dataclasses.field(default_factory=list)
    log_probs: np.ndarray | None = None   # [T, V] float32
    t_valid: int = 0

    @property
    def has_acoustic(self) -> bool:
        return self.log_probs is not None and self.t_valid > 0


TranscribeFn = Callable[[np.ndarray], TranscribeResult]


def is_silence(audio: np.ndarray, threshold: float) -> bool:
    if len(audio) == 0:
        return True
    return float(np.sqrt(np.mean(audio.astype(np.float64) ** 2))) < threshold


def words_match(w1: str, w2: str, threshold: float = 0.7) -> bool:
    if w1 == w2:
        return True
    if len(w1) <= 2 or len(w2) <= 2:
        return False
    return ratio(w1, w2) >= threshold


def align_position(
    recognized: list[str], verse_words: list[str], start_from: int = 0,
    lookahead: int = 5,
) -> tuple[int, list[int]]:
    """Greedy forward alignment (tracker.ts:220-252): returns
    (position, matched verse-word indices)."""
    if not recognized or not verse_words:
        return 0, []
    matched: list[int] = []
    ptr = start_from
    for rec in recognized:
        if ptr >= len(verse_words):
            break
        for j in range(ptr, min(ptr + lookahead, len(verse_words))):
            if words_match(rec, verse_words[j]):
                matched.append(j)
                ptr = j + 1
                break
    if matched:
        return matched[-1] + 1, matched
    return start_from, []


def has_strong_pending_prefix_evidence(matched: list[int], total_words: int) -> bool:
    """Fresh-audio confirmation rule for a deferred next-verse emission
    (tracker.ts:253-266). Matches must be roughly CONTIGUOUS from the
    verse head: the greedy aligner's lookahead lets ubiquitous stop-words
    match scattered positions (measured: mid-10:15 audio "قل ما يكون لي"
    matched 10:16's w0 "قل" and w4 "ما" — first<=1 and len>=2 held, and
    the phantom pending confirmed), but a genuine onset reads the next
    verse's opening words in order without skipping most of them."""
    if not matched:
        return False
    first, last = matched[0], matched[-1]
    if total_words <= 3:
        return first == 0
    contiguous = (last - first + 1) <= len(matched) + 2
    return first <= 1 and (len(matched) >= 2 or last >= 2) and contiguous


def ref_key(surah: int, ayah: int, ayah_end: int | None = None) -> str:
    if ayah_end and ayah_end > ayah:
        return f"{surah}:{ayah}:{ayah_end}"
    return f"{surah}:{ayah}"


# ---------------------------------------------------------------------------
# StreamingHypothesis — per-utterance Viterbi over candidate cycles
# ---------------------------------------------------------------------------

class StreamingHypothesis:
    """Observe verse_candidate cycles + commits; on flush, Viterbi over
    cycles with recitation-shaped transition scores → final_sequence
    (tracker.ts:314-431)."""

    MAX_CYCLES = 80
    TOP_PER_CYCLE = 5

    def __init__(self, params: HypothesisParams | None = None):
        self.params = params or hypothesis_params_from_env()
        self.cycles: list[list[dict]] = []
        self.committed: list[dict] = []

    def observe_candidates(self, message: dict) -> None:
        cands = message.get("candidates") or []
        if not cands:
            return
        self.cycles.append(cands[: self.TOP_PER_CYCLE])
        if len(self.cycles) > self.MAX_CYCLES:
            self.cycles.pop(0)

    def observe_commit(self, message: dict) -> None:
        verse = {
            "surah": message["surah"],
            "ayah": message["ayah"],
            "ayah_end": message.get("ayah_end"),
            "confidence": message.get("confidence", 0.0),
        }
        if not any(
            v["surah"] == verse["surah"] and v["ayah"] == verse["ayah"]
            for v in self.committed
        ):
            self.committed.append(verse)
        # Insert the commit as its own path cycle: commits usually come
        # from the TEXT match (effective), which is absent from the
        # fusion-ranked candidate top-5 — without this the Viterbi path
        # literally cannot contain the verses the tracker emitted
        # (measured: exp 110:3 → path [56:96] while emissions were
        # perfect). The _commit flag exempts this cycle from the
        # committed_refs anchor bonus in _best_path (its confidence
        # already carries commit_anchor — no double counting).
        self.cycles.append([
            {
                "surah": message["surah"],
                "ayah": message["ayah"],
                "ayah_end": message.get("ayah_end"),
                "confidence": min(
                    1.5,
                    message.get("confidence", 0.9) + self.params.commit_anchor,
                ),
                "_commit": True,
            }
        ])
        if len(self.cycles) > self.MAX_CYCLES:
            self.cycles.pop(0)

    def observe_rollback(self, message: dict) -> None:
        """A forcibly retracted (misidentified) commit must not keep
        steering the final path: drop the ref from `committed` (no more
        commit_anchor for matching candidates) and remove its synthetic
        commit cycle so finalize() doesn't have to pay the skip cost of a
        confidence-1.5 cycle to exclude the very verse the tracker just
        retracted (reference rollback semantics: web/server.py:625-675)."""
        surah, ayah = message["surah"], message["ayah"]
        self.committed = [
            v for v in self.committed
            if not (v["surah"] == surah and v["ayah"] == ayah)
        ]
        self.cycles = [
            cycle for cycle in self.cycles
            if not (
                len(cycle) == 1
                and cycle[0].get("_commit")
                and cycle[0]["surah"] == surah
                and cycle[0]["ayah"] == ayah
            )
        ]

    def reset(self) -> None:
        self.cycles = []
        self.committed = []

    def _transition(self, prev: dict, nxt: dict) -> float:
        p = self.params
        if prev["surah"] != nxt["surah"]:
            return (
                p.surah_jump_high_confidence
                if nxt.get("confidence", 0.0) >= 0.85
                else p.surah_jump
            )
        prev_end = prev.get("ayah_end") or prev["ayah"]
        if prev_end < prev["ayah"]:
            prev_end = prev["ayah"]
        delta = nxt["ayah"] - prev_end
        if delta == 0:
            return p.same_ayah
        if delta == 1:
            return p.next_ayah
        if 1 < delta <= 3:
            return p.small_forward_per_ayah * delta
        if delta < 0:
            return p.backward
        return p.far_forward

    @staticmethod
    def _expand(cand: dict) -> list[dict]:
        end = cand.get("ayah_end") or cand["ayah"]
        return [
            {"surah": cand["surah"], "ayah": a,
             "confidence": cand.get("confidence", 0.0)}
            for a in range(cand["ayah"], max(end, cand["ayah"]) + 1)
        ]

    def _best_path(self) -> list[dict]:
        """Skip-aware Viterbi. Emissions are scored RELATIVE to an
        expectation (conf − emission_bias): raw fusion confidences run
        0.7-1.0 even on garbage partial-window cycles, so an additive
        reward makes every cycle worth including and the skip state can
        never win (measured: emissions 100% / path 57% on the v1 oracle).
        With relative emissions, off-flow cycles add negative mass and the
        transition structure decides; skipping a cycle costs what its best
        candidate left on the table (never less than a small constant, so
        confident cycles — commit cycles carry conf ≈ 1.5 — are near-
        mandatory while garbage is near-free to drop)."""
        if not self.cycles:
            return []
        # Expand span commits over every ayah they cover, so a candidate
        # naming any verse of a committed span earns the anchor.
        committed_refs = {
            (v["surah"], a)
            for v in self.committed
            for a in range(v["ayah"], max(v.get("ayah_end") or v["ayah"], v["ayah"]) + 1)
        }
        p = self.params
        # virtual start state: a path may also skip leading cycles
        previous: list[dict] = [{"cand": None, "score": 0.0, "verses": []}]
        for cycle in self.cycles:
            emissions: list[tuple[dict, float]] = []
            for cand in cycle:
                conf = cand.get("confidence", 0.0)
                # Synthetic commit cycles already carry commit_anchor in
                # their confidence — no second helping via committed_refs.
                if (
                    not cand.get("_commit")
                    and committed_refs
                    and any(
                        (v["surah"], v["ayah"]) in committed_refs
                        for v in self._expand(cand)
                    )
                ):
                    conf += p.commit_anchor
                emissions.append((cand, conf - p.emission_bias))
            # anchored confidence == relative emission + bias; no second
            # pass over the cycle needed
            top_conf = max(em for _c, em in emissions) + p.emission_bias
            skip_cost = max(
                0.05, p.skip_scale * (top_conf - p.skip_offset)
            )
            current = []
            for cand, em in emissions:
                verses = self._expand(cand)
                best_prev, best_score = None, -math.inf
                for st in previous:
                    trans = (
                        0.0 if st["cand"] is None
                        else self._transition(st["cand"], cand)
                    )
                    s = st["score"] + em + trans
                    if s > best_score:
                        best_score, best_prev = s, st
                current.append(
                    {
                        "cand": cand,
                        "score": best_score,
                        "verses": best_prev["verses"] + verses,
                    }
                )
            for st in previous:  # skip state
                current.append(
                    {
                        "cand": st["cand"],
                        "score": st["score"] - skip_cost,
                        "verses": st["verses"],
                    }
                )
            # Beam: best state per last ref keeps the DP bounded.
            best_by_ref: dict[tuple, dict] = {}
            for st in current:
                c = st["cand"]
                key = (
                    ("START",) if c is None
                    else (c["surah"], c["ayah"], c.get("ayah_end"))
                )
                if key not in best_by_ref or st["score"] > best_by_ref[key]["score"]:
                    best_by_ref[key] = st
            previous = sorted(
                best_by_ref.values(), key=lambda st: st["score"], reverse=True
            )[: self.TOP_PER_CYCLE * 3]
        return max(previous, key=lambda st: st["score"])["verses"]

    def finalize(self) -> dict | None:
        # Commit-primary final sequence: commits survived every live gate
        # (ambiguity, stability, residual, feasibility), and on REAL runs
        # the candidate-cycle Viterbi scored BELOW the commit stream
        # (measured on round-5 real dumps: pure Viterbi 0.615/0.268 v1/v2
        # vs commits 0.718/0.512) — noisy partial-window candidate cycles
        # drag the path off verses the tracker already proved. The Viterbi
        # path's real value is the COMMIT-LESS utterance, where it
        # recovers verses the live gates never passed (commit-primary
        # total: 0.769/0.537 — above both). The reference runs its
        # per-utterance Viterbi unconditionally (tracker.ts:314-431); this
        # split is the measured improvement on that design.
        if self.committed and self.params.commit_primary:
            verses = []
            for c in self.committed:
                end = c.get("ayah_end") or c["ayah"]
                for a in range(c["ayah"], end + 1):
                    verses.append(
                        {"surah": c["surah"], "ayah": a,
                         "confidence": c.get("confidence", 0.9)}
                    )
        else:
            path = self._best_path()
            verses = path if path else self.committed
        if not verses:
            return None
        deduped: list[dict] = []
        for v in verses:
            if not any(
                d["surah"] == v["surah"] and d["ayah"] == v["ayah"] for d in deduped
            ):
                deduped.append(v)
        confidence = sum(v["confidence"] for v in deduped) / len(deduped)
        return {
            "type": "final_sequence",
            "verses": deduped,
            "confidence": round(confidence, 2),
        }


# ---------------------------------------------------------------------------
# RecitationTracker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CommitEvidence:
    confidence: float
    acoustic_margin: float
    strong: bool
    rescue: bool = False  # single-window short-verse rescue (a guess)


class RecitationTracker:
    def __init__(
        self,
        transcribe: TranscribeFn,
        db: QuranDB | None = None,
        token_store: TokenStore | None = None,
        config: StreamingConfig | None = None,
        on_diagnostic: Callable[[dict], None] | None = None,
        hypothesis_params: HypothesisParams | None = None,
    ):
        self.transcribe = transcribe
        self.db = db or QuranDB()
        self.token_store = token_store or TokenStore.load_default()
        self.config = config or DEFAULT_STREAMING_CONFIG
        self.on_diagnostic = on_diagnostic
        self.hypothesis = StreamingHypothesis(hypothesis_params)
        self.last_hypothesis_snapshot: dict | None = None
        # (surah, ayah) of the last DROPPED deferred emission + the sample
        # clock at the drop — fuels the gap-fill rule below
        self.dropped_pendings: list[tuple[tuple[int, int], int]] = []
        self.tie_rival_texts: list[str] = []
        # refs emitted in this utterance — final-flush dedup
        self.emitted_refs_utterance: set[tuple[int, int]] = set()

        self._short_verse_cache: list[dict] | None = None
        self.reset()

    # ------------------------------------------------------------- control

    def reset(self) -> None:
        self.utterance_audio = np.zeros(0, dtype=np.float32)
        self.total_samples_fed = 0
        self.peak_rms = 0.0
        self.new_audio_count = 0
        self.silence_samples = 0
        self.utterance_has_speech = False
        self.did_final_flush = False
        self.cycles_since_commit = 0
        self.pending_leader: tuple[str, int] | None = None
        self.rescue_leader: tuple[tuple[int, int], int] | None = None
        self.last_leader_candidate: tuple[dict, float] | None = None
        self.last_raw_transcript: str | None = None

        self.weak_flush_commit: dict | None = None
        self.prev_weak_flush_commit: dict | None = None
        self.unmatched_flush_text: tuple[str, int] | None = None
        self.last_emitted_ref: tuple[int, int] | None = None
        self.last_emitted_text = ""
        self.last_emitted_msg: dict | None = None
        self.prev_emitted_ref: tuple[int, int] | None = None
        self.prev_emitted_text = ""
        self.prev_emitted_msg: dict | None = None
        self.last_commit_evidence: _CommitEvidence | None = None
        self.consecutive_auto_advances = 0
        self.emitted_refs_utterance = set()
        self.dropped_pendings = []

        self.tracking_verse: dict | None = None
        self.tracking_verse_words: list[str] = []
        self.tracking_last_word_idx = -1
        self.tracking_lexical_word_idx = -1
        self.tracking_min_lexical_idx = 10**9
        self.tracking_progress_established = False
        self.tracking_primary_matches = 0
        self.stale_speech_cycles = 0
        self.stale_cycles = 0
        self.last_tracking_result: TranscribeResult | None = None

        self.tracking_pending_emission = False
        self.pending_emission_message: dict | None = None
        self.pending_emission_margin = math.inf
        self.pre_advance_snapshot: dict | None = None
        self.samples_at_advance = 0

        self.hypothesis.reset()

    def set_config(self, partial: dict | StreamingConfig) -> None:
        from tilawa_tpu_torch.streaming.config import normalize_streaming_config

        self.config = normalize_streaming_config(partial, base=self.config)

    # ---------------------------------------------------------------- feed

    @property
    def in_tracking(self) -> bool:
        return self.tracking_verse is not None

    def feed(self, samples: np.ndarray) -> list[dict]:
        cfg = self.config
        samples = np.asarray(samples, dtype=np.float32)
        self.total_samples_fed += len(samples)
        self.utterance_audio = np.concatenate([self.utterance_audio, samples])
        max_samples = cfg.samples(
            cfg.tracking_max_window_sec if self.in_tracking
            else cfg.discovery_max_window_sec
        )
        if len(self.utterance_audio) > max_samples:
            self.utterance_audio = self.utterance_audio[-max_samples:]
        self.new_audio_count += len(samples)

        # Adaptive silence floor: the configured absolute threshold is
        # tuned for normal-level mics (reference: types.ts
        # silence_rms_threshold 0.005), but very quiet recordings sit
        # entirely below it (measured: tlog clips peaking at RMS 0.0026 —
        # the whole clip read as silence and nothing was ever decoded).
        # Scale the gate down to a fraction of the session's observed peak,
        # never below a digital-noise floor; loud sessions are unchanged
        # (min() keeps the configured value as the ceiling). This serves
        # the product's speaker/recording-invariance constraint
        # (reference README.md:198-208).
        chunk_rms = (
            float(np.sqrt(np.mean(samples.astype(np.float64) ** 2)))
            if len(samples) else 0.0
        )
        self.peak_rms = max(self.peak_rms, chunk_rms)
        # Only adapt DOWNWARD after sustained evidence the whole session is
        # quiet: >=2 s observed with the peak still within 4x the
        # configured threshold (quiet recordings peak ~0.003-0.02 even
        # through plosive transients; normal mics peak 0.05+ as soon as
        # real speech lands, which disables the adaptation for good). At
        # session start peak_rms ~= 0, and an unconditional min()
        # collapsed the floor to 8e-4, promoting ambient noise
        # (RMS 0.001-0.005) to speech on normal-level mics (ADVICE r4).
        if (
            self.total_samples_fed >= cfg.samples(2.0)
            and self.peak_rms < 4.0 * cfg.silence_rms_threshold
        ):
            eff_threshold = min(
                cfg.silence_rms_threshold, max(8e-4, 0.25 * self.peak_rms)
            )
        else:
            eff_threshold = cfg.silence_rms_threshold
        if chunk_rms < eff_threshold:
            self.silence_samples += len(samples)
        else:
            self.silence_samples = 0
            self.utterance_has_speech = True
            self.did_final_flush = False
            # resumption after a flush commit: the advance machinery may
            # run again — this is NEW evidence, not the committed tail
            self.tracking_awaits_fresh_speech = False

        final_flush = (
            self.utterance_has_speech
            and not self.did_final_flush
            and self.silence_samples >= cfg.samples(cfg.final_silence_sec)
        )

        if self.in_tracking:
            messages = self._handle_tracking(final_flush)
        else:
            messages = self._handle_discovery(final_flush)

        for m in messages:
            if m["type"] == "verse_candidate":
                self.hypothesis.observe_candidates(m)
            elif m["type"] == "verse_match":
                self.hypothesis.observe_commit(m)
                end = m.get("ayah_end") or m["ayah"]
                self.emitted_refs_utterance.update(
                    (m["surah"], a) for a in range(m["ayah"], end + 1)
                )
            elif m["type"] == "verse_rollback":
                self.hypothesis.observe_rollback(m)
                end = m.get("ayah_end") or m["ayah"]
                self.emitted_refs_utterance.difference_update(
                    (m["surah"], a) for a in range(m["ayah"], end + 1)
                )

        if final_flush:
            # Snapshot the Viterbi inputs before any utterance reset wipes
            # them — offline HypothesisParams sweeps re-finalize from this
            # (eval/hypothesis_sweep.py, TILAWA_DUMP_HYPOTHESIS).
            snap = {
                "cycles": [list(c) for c in self.hypothesis.cycles],
                "committed": list(self.hypothesis.committed),
            }
            # A trailing silence re-flush after the utterance reset sees an
            # EMPTY hypothesis — don't let it clobber the real snapshot.
            if (
                snap["cycles"] or snap["committed"]
                or self.last_hypothesis_snapshot is None
            ):
                self.last_hypothesis_snapshot = snap
            final_seq = self.hypothesis.finalize()
            if final_seq:
                messages.append(final_seq)
            self.did_final_flush = True
            self._diag(
                type="flush",
                mode="tracking" if self.in_tracking else "discovery",
                duration_sec=len(self.utterance_audio) / SAMPLE_RATE,
            )
            if not self.in_tracking:
                self._reset_utterance()
            else:
                # A tracking-mode flush ends the utterance too: clear the
                # duplicate-suppression set so a verse the user genuinely
                # re-recites later isn't suppressed at the next flush
                # (ADVICE r3 — the set previously only cleared on the
                # discovery-mode _reset_utterance path).
                self.emitted_refs_utterance = set()
        return messages

    # ----------------------------------------------------------- discovery

    def _handle_discovery(self, final_flush: bool) -> list[dict]:
        cfg = self.config
        messages: list[dict] = []
        if not self.utterance_has_speech:
            self._diag(type="silence_skip", mode="discovery", reason="no speech")
            return messages
        if not final_flush and self.new_audio_count < cfg.samples(
            cfg.discovery_trigger_sec
        ):
            return messages
        self.new_audio_count = 0
        self.cycles_since_commit += 1

        result = self.transcribe(self.utterance_audio)
        text = result.text.strip()

        if not text or len(text.replace(" ", "")) < 5:
            # content chars, not raw length: "لكم د" is 4 letters of real
            # evidence — too little to retrieve on, exactly what the CTC
            # short-verse rescue exists for (the space pushed it past the
            # old gate and into a doomed discovery match)
            rescue = self._short_utterance_rescue(result, final_flush)
            if rescue:
                return rescue
            # Flush-empty fallback: quiet short clips can spend their whole
            # runway before the silence floor adapts, leaving ONE live
            # cycle whose near-exact leader then dies when the flush window
            # decodes to nothing (measured: retasy_v2_008 — the live cycle
            # read 112:2's text verbatim at ~1.0, no commit fired, and the
            # flush decoded empty; only the Viterbi path recovered it).
            # With no commit this utterance and near-exact single-cycle
            # text evidence, the flush commits that leader.
            if (
                final_flush
                and self.last_emitted_ref is None
                and getattr(self, "last_leader_candidate", None)
            ):
                cand, lscore = self.last_leader_candidate
                if lscore >= 0.9:
                    msg = self._verse_match_message(cand, min(0.95, lscore))
                    self._diag(
                        type="commit",
                        ref=ref_key(cand["surah"], cand["ayah"],
                                    cand.get("ayah_end")),
                        reason="flush_last_leader",
                        confidence=round(min(0.95, lscore), 2),
                    )
                    self.last_emitted_msg = msg
                    self.last_emitted_ref = (cand["surah"], cand["ayah"])
                    self.last_emitted_text = cand.get("text_clean", "")
                    self.last_commit_evidence = _CommitEvidence(
                        lscore, 0.0, False
                    )
                    self.last_leader_candidate = None
                    return [msg]
            self._diag(type="silence_skip", mode="discovery",
                       reason="transcript too short")
            return messages

        # Residual overlap vs the last emitted verse. Live cycles skip the
        # whole transcript; the final flush instead strips the leading
        # residual and matches only the genuinely-new tail (reference:
        # web/server.py:528-559 _strip_leading_residual — skipping at flush
        # drops recall on multi-ayah clips, but matching the raw residual
        # lets the continuation bonus commit a phantom next verse).
        # Weak (tie-flush) commits get residual processing too: their
        # leftover tails otherwise commit shared-tail phantoms — 22:14's
        # verbatim second half clear-margined 9:89 at flush, and the
        # phantom then superseded-rolled-back the CORRECT verse. The
        # skip/strip machinery's own guards (continuation check, length
        # caps, next-verse break) keep genuinely new content flowing.
        if self.last_emitted_text and self.last_commit_evidence:
            residual = partial_ratio(text, self.last_emitted_text)
            text_chars = len(text.replace(" ", ""))
            emitted_chars = len(self.last_emitted_text.replace(" ", ""))
            # A long verse committed early leaves a multi-window remainder
            # that outgrows the NEXT emission's text — compare against the
            # last TWO emissions so that remainder still reads as leftover
            # (measured: after 10:15 then phantom 10:16, the rest of 10:15
            # — 27 words — failed the single-emission cap and retrieved
            # phantom span 39:11-13 at flush).
            if self.prev_emitted_text:
                combined = self.prev_emitted_text + " " + self.last_emitted_text
                r2 = partial_ratio(text, combined)
                if r2 > residual:
                    residual = r2
                    emitted_chars = len(combined.replace(" ", ""))
            looks_like_leftover = text_chars <= math.ceil(emitted_chars * 1.15)
            # Tie-rival passthrough: after a coin-flip (tie-flush) commit,
            # a window matching the RECORDED rival's text better than the
            # committed verse's is the rival's disambiguating tail.
            rival_beats = any(
                partial_ratio(text, rt) >= max(0.8, residual - 0.02)
                for rt in self.tie_rival_texts
            )
            reads_cont = self._reads_as_continuation(text, residual)
            if (
                residual > 0.7 and looks_like_leftover and not final_flush
                and not reads_cont
                and not rival_beats
            ):
                self._diag(type="silence_skip", mode="discovery",
                           reason=f"residual={residual:.3f}")
                return messages
            # Partial residual, live or flush: the window mixes the emitted
            # verse's tail with the next verse's onset ("…زكريا" + "اذ").
            # Matching the RAW mix hands fusion a garbled query that can
            # clear-margin a phantom (measured: 26:196 at 0.99 on
            # "ه ⁇ زكريا اذ" right after 19:2). Strip the leading residual
            # (reference: web/server.py:528-559 strips in discovery) and
            # wait/skip if what remains is too short to match. A window the
            # refrain guard vouches for is NEW content even when it fuzzy-
            # matches the emitted text (identical-refrain surahs: 109:5's
            # text == 109:3's — the strip ate the whole verse and the skip
            # chain dropped 109:4-5), so it must not be stripped either.
            remainder = (
                text if reads_cont else self._strip_residual_prefix(text)
            )
            if remainder != text:
                if (
                    len(remainder.replace(" ", "")) < 5
                    or len(remainder.split()) < 2
                ):
                    self._diag(type="silence_skip", mode="discovery",
                               reason=f"residual_short={residual:.3f}")
                    return messages
                self._diag(type="residual_strip", mode="discovery",
                           kept=remainder, dropped=len(text) - len(remainder))
                text = remainder

        match = self.db.match_verse(
            text,
            threshold=RAW_TRANSCRIPT_THRESHOLD,
            max_span=DISCOVERY_MAX_SPAN,
            hint=self.last_emitted_ref,
            return_top_k=5,
            seeded_spans=True,
        )
        text_confidence_low = (
            match is None or match["score"] < cfg.verse_match_threshold + 0.10
        )
        single_limit = (
            DISCOVERY_EXPANDED_CANDIDATES if text_confidence_low
            else DISCOVERY_TOP_SINGLE_CANDIDATES
        )
        retrieved = self._retrieve_candidates(text, match, single_limit)
        # Prefix-blend rescoring is a LIVE mid-verse heuristic ("we may
        # only have heard the head of the true verse so far"). At final
        # flush no more audio is coming, so the head-of-a-longer-verse
        # reading is dead and full-ratio must decide — otherwise the long
        # prefix-twin wins over the actually-recited short verse (3:2's
        # complete text scored 0.98 as a "prefix of 2:255" at flush; a
        # truncated recording of 3:2's own opening must also resolve to
        # the shorter twin). Mid-verse PAUSE flushes are instead protected
        # by the continuation rule in _derive_effective_match: the
        # expected next verse cannot be overridden by a weak-text rival.
        if not final_flush:
            for c in retrieved:
                c["score"] = prefix_blend_score(
                    text, c.get("text_clean", ""), float(c.get("score", 0.0))
                )
        # A prefix-rescored candidate that clearly beats the text match is
        # better text evidence than the match itself (mid-verse the full
        # matcher penalizes the true longer verse for its unheard tail).
        best_text_cand = max(
            retrieved, key=lambda c: float(c.get("score", 0.0)), default=None
        )
        if best_text_cand is not None:
            best_cand_score = float(best_text_cand.get("score", 0.0))
            if match is None or best_cand_score > float(match["score"]) + 0.02:
                promoted = dict(best_text_cand)
                if match is not None:
                    promoted.setdefault("runners_up", match.get("runners_up", []))
                match = promoted
        text_confidence_low = (
            match is None or match["score"] < cfg.verse_match_threshold + 0.10
        )
        ranked = self._rank_candidates(retrieved, result)

        self._diag(
            type="discovery_cycle",
            text=text,
            final_flush=final_flush,
            candidates=[
                {
                    "ref": ref_key(r["candidate"]["surah"], r["candidate"]["ayah"],
                                   r["candidate"].get("ayah_end")),
                    "stage_a": round(r["candidate"].get("score", 0.0), 3),
                    "acoustic": round(r["acoustic_score"], 3)
                    if math.isfinite(r["acoustic_score"]) else None,
                    "fusion": round(r["fusion_score"], 3),
                    "length_fit": round(r["length_fit"], 3),
                    "feasible": r["feasible"],
                }
                for r in ranked[:8]
            ],
        )

        effective, score, acoustic_margin, length_fit = self._derive_effective_match(
            match, ranked, result, text_confidence_low, final_flush
        )

        threshold = (
            cfg.verse_match_threshold if self.last_emitted_ref
            else cfg.first_match_threshold
        )
        if effective is None or score < threshold:
            if final_flush and len(text.split()) >= 3:
                # A flush that ends an utterance with NO commit may be the
                # first half of a pause-chopped verse: stash the window so
                # the next utterance's commit can try the joined reading
                # (tlog_m059: "…viستنبونك احق هو قل اي" flushed uncommitted;
                # the resumed tail then matched suffix-twin 6:134 instead
                # of the true 10:53 — the JOINED text matches 10:53 at
                # 0.955).
                self.unmatched_flush_text = (text, self.total_samples_fed)
            if effective is not None and score >= RAW_TRANSCRIPT_THRESHOLD:
                messages.append(
                    {"type": "raw_transcript", "text": text,
                     "closest_match": ref_key(effective["surah"], effective["ayah"],
                                              effective.get("ayah_end")),
                     "score": round(score, 3)}
                )
            else:
                messages.append({"type": "raw_transcript", "text": text})
            self.last_raw_transcript = text
            return messages

        key = ref_key(effective["surah"], effective["ayah"], effective.get("ayah_end"))
        if self.pending_leader and self.pending_leader[0] == key:
            self.pending_leader = (key, self.pending_leader[1] + 1)
        else:
            self.pending_leader = (key, 1)
        # remembered for the flush-empty fallback below: a near-exact live
        # leader must survive a flush window that decodes to nothing.
        # RAW text score, not fusion (acoustics can push garbage to 0.9+)
        self.last_leader_candidate = (
            dict(effective), float(effective.get("score", 0.0))
        )

        is_continuation = self._is_continuation(effective["surah"], effective["ayah"])
        clear_margin = length_fit >= 0.6 and acoustic_margin >= (
            cfg.acoustic_continuation_margin if is_continuation
            else cfg.acoustic_clear_margin
        )
        repeated_leader = self.pending_leader[1] >= cfg.discovery_repeat_cycles
        # Ambiguity gate on live non-continuation commits: if a different,
        # non-overlapping verse scores within AMBIGUITY_GAP of the leader,
        # the transcript is still a shared prefix — wait for more audio or
        # the final flush (reference: web/server.py:914-945 requires a
        # >=0.05 gap before ambiguous commits). Applies to both
        # repeated-leader and acoustic clear-margin commits: mid-verse, a
        # shared opening (e.g. "إلا الذين آمنوا وعملوا الصالحات" for 84:25
        # vs 103:3) can give the wrong shorter verse a clear acoustic
        # margin before the true verse is even retrievable.
        # (a near-perfect leader is unambiguous even when another verse
        # embeds the same text — e.g. the bismillah inside 27:30)
        text_ambiguous = False
        flush_tie_partial = False
        # At final flush the gate must not defer (often no more audio is
        # coming) — but a near-tie on a PARTIAL read is a mid-verse PAUSE
        # flush between prefix-twins and the full-ratio pick is a coin
        # flip (measured: 45:15 at 0.883 vs 41:46 at 0.881 on the shared
        # opening "من عمل صالحا فلنفسه ومن أساء فعليها"). Commit, but
        # leave the evidence WEAK so the superseded-commit rollback can
        # retract it when the twin's distinguishing tail commits.
        if final_flush and not is_continuation and _strip_bismillah(text):
            rival_f = self._best_rival_text_score(effective, match, ranked)
            leader_chars = len(
                (effective.get("text_clean") or "").replace(" ", "")
            )
            text_chars_f = len(text.replace(" ", ""))
            if (
                score - rival_f < AMBIGUITY_GAP
                and leader_chars
                and text_chars_f < 0.8 * leader_chars
            ):
                flush_tie_partial = True
                self._diag(type="flush_tie", leader=round(score, 3),
                           rival=round(rival_f, 3))
                # Remember WHO tied: later windows matching the rival's
                # text better than the committed verse's are the
                # disambiguating tail, not leftover — the residual skip
                # lets them through (41:46's "وما ربك بظلام للعبيد" after
                # the coin-flip 45:15 commit).
                self.tie_rival_texts = self._rival_texts(
                    effective, match, ranked
                )
        # A pure-bismillah window is exempt: it IS 1:1 and simultaneously
        # the head of every surah's with-bismillah variant, so every rival
        # measure saturates at 1.0 and the gate would defer forever.
        if not final_flush and not is_continuation and _strip_bismillah(text):
            rival = self._best_rival_text_score(effective, match, ranked)
            # Prefix-consistency rival check, and no high-score exemption:
            # a perfect leader is STILL ambiguous when the window text also
            # reads as the head of a longer rival (2:255 opens with exactly
            # 3:2's full text; "ما اغني عن" is both most of 69:28 and the
            # head of 111:2) or as the WHOLE of a shorter one (the same
            # twin from the other side). More audio settles it: either the
            # text grows past the short twin (prefix-blend flips the
            # leader) or the flush full-ratio match picks the short one.
            # Embedded-not-prefix rivals (the bismillah inside 27:30) score
            # low on both measures, which is what the old >=0.98 exemption
            # was protecting.
            rival_prefix = self._best_rival_prefix_consistency(
                effective, match, ranked, text
            )
            rival = max(rival, rival_prefix)
            if score - rival < AMBIGUITY_GAP:
                text_ambiguous = True
                repeated_leader = False
                self._diag(
                    type="advance_decision",
                    action="deferred",
                    reason=f"text near-tie leader={score:.3f} rival={rival:.3f}",
                )

        messages.append(
            {
                "type": "verse_candidate",
                "candidates": [
                    {
                        "surah": r["candidate"]["surah"],
                        "ayah": r["candidate"]["ayah"],
                        "ayah_end": r["candidate"].get("ayah_end"),
                        "confidence": round(min(1.0, max(r["fusion_score"], 0.0)), 3),
                        "rank": i + 1,
                        "source": "discovery",
                    }
                    for i, r in enumerate(ranked[:5])
                ],
                "stable": repeated_leader or final_flush,
                "final_flush": final_flush,
            }
        )

        # Anti-cascade: block live non-continuation jumps right after a
        # commit (tracker.ts:1381-1415).
        blocked = False
        if self.last_emitted_ref and not is_continuation and not final_flush:
            blocked = True
            self._diag(
                type="advance_decision",
                action="blocked",
                reason="live non-continuation discovery blocked",
                from_ref=ref_key(*self.last_emitted_ref),
                to_ref=key,
            )
        if blocked or text_ambiguous:
            redeemed = self._try_joined_window_redemption(text)
            if redeemed:
                messages.extend(redeemed)
                return messages
        if (
            not is_continuation
            and self.last_emitted_ref
            and self.cycles_since_commit <= 2
            and score < cfg.non_continuation_jump_threshold
            and not repeated_leader
        ):
            blocked = True

        final_flush_commit = final_flush and score >= threshold
        if (
            final_flush_commit
            and is_continuation
            and self.last_emitted_ref
            and len(text.split()) <= 4
        ):
            # Trailing-audio phantom continuations: after a verse commits,
            # a short garbled leftover window at flush can clear the fusion
            # threshold for the NEXT verse (measured: "وس واياك نست" after
            # 10:52 committed phantom 10:53 at 0.62). A genuine
            # continuation fragment this short is the next verse's HEAD —
            # demand it reads as such.
            cont_head = " ".join(
                (effective.get("text_clean", "") or "").split()[:5]
            )
            if cont_head and partial_ratio(text, cont_head) < 0.55:
                final_flush_commit = False
                self._diag(
                    type="advance_decision", action="blocked",
                    reason="flush continuation window not the verse head",
                    to_ref=key,
                )
        if final_flush_commit and not is_continuation and self.last_emitted_ref:
            # Mid-recitation flush phantoms: a <=4-word garbled leftover
            # window at final flush can match some other surah's verse
            # tail well enough to clear the fusion threshold (measured:
            # "من ا فيها حب" — 91:5's stripped leftover — committed 80:27
            # at 0.99 after the full 91:1-5 sequence). Demand REAL text
            # evidence from the candidate itself before a different-surah
            # flush commit on so little audio.
            raw_text = float(effective.get("score", 0.0))
            for r in ranked:
                c = r["candidate"]
                if (c["surah"], c["ayah"]) == (
                    effective["surah"], effective["ayah"],
                ):
                    raw_text = float(c.get("score", 0.0))
                    break
            if (
                len(text.split()) <= 4
                and effective["surah"] != self.last_emitted_ref[0]
                and raw_text < 0.75
            ):
                final_flush_commit = False
                self._diag(
                    type="advance_decision", action="blocked",
                    reason=f"flush short-window weak text ({raw_text:.2f})",
                    to_ref=key,
                )

        # Decode-stability gate on single-cycle clearMargin commits.
        clear_margin_allowed = clear_margin and not text_ambiguous
        if (
            cfg.decode_stability_enabled
            and clear_margin
            and not is_continuation
        ):
            prev = self.last_raw_transcript
            stable = bool(prev) and ratio(prev, text) >= cfg.decode_stability_ratio
            if not stable:
                clear_margin_allowed = False
        self.last_raw_transcript = text

        if not blocked and (clear_margin_allowed or repeated_leader or final_flush_commit):
            # Flush span shrink-test: at final flush the transcript is all
            # there is, so a span that extends past what was recited loses
            # to its own prefix on full ratio — drop trailing verses while
            # the ratio improves (measured: 70:4-6 committed on a 70:4+5
            # transcript; ratio(text, 4:5)=1.0 vs 4:6=0.89; reference
            # analogue: SPAN_PENALTY in the batch rerank,
            # c2c-direct/run.py:376).
            if final_flush:
                a_end0 = effective.get("ayah_end") or effective["ayah"]
                a0 = effective["ayah"]
                if a_end0 > a0:
                    s0 = effective["surah"]
                    best_e = a_end0
                    best_r = ratio(
                        text, self.db.span_text(s0, a0, a_end0) or ""
                    )
                    e = a_end0
                    while e > a0:
                        e -= 1
                        r = ratio(
                            text,
                            (self.db.span_text(s0, a0, e) if e > a0 else
                             (self.db.get_verse(s0, a0) or {}).get(
                                 "text_clean", "")) or "",
                        )
                        if r > best_r + 1e-9:
                            best_e, best_r = e, r
                        else:
                            break
                    if best_e != a_end0:
                        effective = dict(effective)
                        effective["ayah_end"] = (
                            best_e if best_e > a0 else None
                        )
                        effective["text_clean"] = (
                            self.db.span_text(s0, a0, best_e)
                            if best_e > a0 else
                            (self.db.get_verse(s0, a0) or {}).get(
                                "text_clean", "")
                        )
                        key = ref_key(s0, a0, effective.get("ayah_end"))
            # Joined-window upgrade: if the previous utterance flushed
            # WITHOUT a commit, the current leader may be matching only
            # the tail half of a pause-chopped verse (suffix twins win
            # exactly there). If stash+window reads decisively better as
            # one verse, commit THAT verse.
            if self.unmatched_flush_text is not None:
                stash, at0 = self.unmatched_flush_text
                self.unmatched_flush_text = None
                if self.total_samples_fed - at0 <= 15 * 16000:
                    eff_raw = float(effective.get("score", 0.0))
                    jm = self.db.match_verse(
                        (stash + " " + text).strip(),
                        max_span=4, seeded_spans=True,
                    )
                    if jm is not None and (
                        jm["surah"], jm["ayah"],
                    ) != (effective["surah"], effective["ayah"]):
                        j_text = jm.get("text_clean") or (
                            self.db.get_verse(jm["surah"], jm["ayah"]) or {}
                        ).get("text_clean", "")
                        if (
                            jm["score"] >= max(0.85, eff_raw + 0.1)
                            and j_text
                            and partial_ratio(stash, j_text) >= 0.55
                        ):
                            effective = dict(jm)
                            effective.setdefault("text_clean", j_text)
                            key = ref_key(
                                jm["surah"], jm["ayah"], jm.get("ayah_end")
                            )
                            self._diag(
                                type="commit", ref=key,
                                reason="joined_window_upgrade",
                                confidence=round(float(jm["score"]), 2),
                            )
            ref = (effective["surah"], effective["ayah"])
            emitted_end = None
            if self.last_emitted_ref and ref[0] == self.last_emitted_ref[0]:
                emitted_end = self.last_emitted_ref[1]
                if self.last_emitted_msg and self.last_emitted_msg.get(
                    "surah"
                ) == ref[0]:
                    emitted_end = max(
                        emitted_end,
                        self.last_emitted_msg.get("ayah_end")
                        or self.last_emitted_msg["ayah"],
                    )
            if (
                emitted_end is not None
                and self.last_emitted_ref[1] <= ref[1] <= emitted_end
            ):
                # The commit starts INSIDE the already-emitted span. Same
                # start: a span still carries news if it extends past the
                # emitted end — emit the unemitted remainder (measured:
                # flush leader 114:5-6 right after committing 114:5 dropped
                # the final verse 114:6). Interior start with no extension
                # is a residual re-read of already-emitted audio — and
                # committing it drags tracking BACKWARD (measured: window
                # over Fatiha verse 6 text-matched 1:4 after the 1:3-5
                # span; the bogus commit re-anchored tracking at 1:4 and
                # verse 6 was never emitted).
                a_end = effective.get("ayah_end") or ref[1]
                if a_end <= emitted_end:
                    self._diag(
                        type="commit", ref=key, reason="residual_in_span",
                        confidence=0.0,
                    )
                    return messages
                rest_start = emitted_end + 1
                rest = dict(effective)
                rest["ayah"] = rest_start
                rest["ayah_end"] = a_end if a_end > rest_start else None
                rest["text_clean"] = (
                    self.db.span_text(ref[0], rest_start, a_end)
                    or (self.db.get_verse(ref[0], rest_start) or {}).get(
                        "text_clean", ""
                    )
                )
                effective = rest
                ref = (ref[0], rest_start)
                key = ref_key(ref[0], rest_start, rest.get("ayah_end"))
            if final_flush_commit:
                a_end_new = effective.get("ayah_end") or ref[1]
                if all(
                    (ref[0], a) in self.emitted_refs_utterance
                    for a in range(ref[1], a_end_new + 1)
                ):
                    # Final-flush commits re-reading ONLY verses already
                    # emitted this utterance are leftover-audio re-reads,
                    # not new recitation (measured: flush re-committed
                    # 44:5 after the spurious 44:6, duplicating it).
                    self._diag(
                        type="commit", ref=key,
                        reason="flush_duplicate_suppressed", confidence=0.0,
                    )
                    return messages
            confidence = max(
                score, min(0.99, 0.45 + acoustic_margin + length_fit * 0.2)
            )
            # Superseded-commit rollback: a confident commit in a DIFFERENT
            # surah right after a weak commit that never tracked any
            # progress is direct evidence the weak one was a misread
            # (measured: a partial first window short-rescued 20:34 at
            # 0.77/margin 0.27, then five blocked cycles all led 10:10 —
            # the real verse — which finally committed at 0.99 while the
            # phantom stayed emitted). Weak-only via _rollback_weak_commit:
            # strong or progress-backed commits are never retracted, so a
            # genuine surah transition is unaffected.
            prior_is_rescue = bool(
                self.last_commit_evidence
                and self.last_commit_evidence.rescue
            )
            if (
                not is_continuation
                and self.last_emitted_ref
                and ref[0] != self.last_emitted_ref[0]
                and (
                    confidence >= 0.9
                    # A REPEATED leader in another surah supersedes a
                    # single-window rescue at any confidence: the rescue
                    # was a guess on one garbled window; a leader that
                    # keeps winning cycles is systematic evidence
                    # (measured: start-of-utterance rescue 106:1 at margin
                    # 1.03 survived 91:1-2's repeated-leader commit at
                    # 0.77 and bracketed the whole correct sequence).
                    or (repeated_leader and prior_is_rescue)
                )
            ):
                rb = self._rollback_weak_commit(
                    "superseded by non-continuation commit"
                )
                if rb:
                    messages.append(rb)
            # Gap-fill a recently DROPPED deferred emission: the reciter
            # advanced past verse X while its pending emission was waiting
            # for confirmation evidence; the next discovery then commits
            # X+1 directly and X silently vanishes (measured: 95:2 pending
            # dropped, 95:3 committed — final emissions skipped a verse
            # the reciter read). If the new commit is the immediate
            # successor of a pending verse dropped within the last ~8 s
            # and that verse still fills a one-ayah gap after the emitted
            # end, emit it first at modest confidence.
            if self.dropped_pendings:
                # Same-surah gap must be CONFIRMED (ADVICE r3): when
                # emitted_end is None — last emission in another surah or
                # rolled back — the dropped pending is most likely part of
                # a misidentified chain, not a skipped verse, so don't
                # resurrect it. Only a confident non-flush successor
                # commit counts as evidence the reciter really passed
                # through the gap.
                chain = (
                    self._dropped_chain_for(
                        ref[0], ref[1], require_bottom_after=emitted_end
                    )
                    if emitted_end is not None
                    and not final_flush_commit
                    and confidence >= 0.9
                    else []
                )
                for (ds, da) in chain:
                    gap_verse = self.db.get_verse(ds, da)
                    if gap_verse:
                        messages.append(
                            self._verse_match_message(gap_verse, 0.72)
                        )
                        self._diag(
                            type="commit", ref=ref_key(ds, da),
                            reason="gap_fill_dropped_pending",
                            confidence=0.72,
                        )
                self.dropped_pendings = []
            emit_msg = self._verse_match_message(effective, confidence)
            messages.append(emit_msg)
            self._diag(
                type="commit",
                ref=key,
                reason=(
                    "final_flush" if final_flush_commit and not clear_margin_allowed
                    and not repeated_leader else
                    "repeated_leader" if repeated_leader else "clear_margin"
                ),
                confidence=round(confidence, 2),
            )
            # prev_* must capture the PREVIOUS emission before any
            # overwrite — saving prev_emitted_msg after assigning
            # last_emitted_msg aliased it to the NEW message, so a weak
            # rollback restored the retracted message itself (code review
            # r3 finding #1).
            self.prev_emitted_ref = self.last_emitted_ref
            self.prev_emitted_text = self.last_emitted_text
            self.prev_emitted_msg = self.last_emitted_msg
            self.last_emitted_msg = emit_msg
            self.last_emitted_ref = ref
            # Span commits must remember the FULL span text: the residual
            # check compares later windows against last_emitted_text, and a
            # tail fragment of the span's second verse reads as novel
            # content if only the first verse's text is kept (measured:
            # after committing 103:2-3, the flush window "الصلحت وتواص" —
            # mid-103:3 — matched phantom 92:16).
            a_end = effective.get("ayah_end") or ref[1]
            span_text = (
                self.db.span_text(ref[0], ref[1], a_end)
                if a_end != ref[1] else None
            )
            verse = self.db.get_verse(*ref)
            self.last_emitted_text = span_text or (verse or {}).get(
                "text_clean", text
            )
            self.last_commit_evidence = _CommitEvidence(
                confidence=confidence,
                acoustic_margin=acoustic_margin,
                strong=(clear_margin or repeated_leader)
                and not flush_tie_partial,
            )
            # A flush commit on a SHORT window with weak text evidence may
            # be the first half of a pause-chopped verse; watch it for
            # joined-window redemption if speech resumes.
            # effective["score"] can carry fusion/blend influence; the
            # pause-chop suspicion gate needs the RAW text ratio of the
            # committed ref (the retrieval candidate's own score)
            eff_text_score = float(effective.get("score", 0.0))
            for r in ranked:
                c = r["candidate"]
                if (c["surah"], c["ayah"]) == ref:
                    eff_text_score = float(c.get("score", 0.0))
                    break
            self.prev_weak_flush_commit = self.weak_flush_commit
            if (
                final_flush
                and len(text.split()) <= 6
                and eff_text_score < 0.65
            ):
                self.weak_flush_commit = {
                    "ref": ref,
                    "window_text": text,
                    "text_score": eff_text_score,
                    "at": self.total_samples_fed,
                }
            else:
                self.weak_flush_commit = None
            if not flush_tie_partial:
                self.tie_rival_texts = []
            self.pending_leader = None
            self.cycles_since_commit = 0
            self.consecutive_auto_advances = 0
            # Track the span's LAST verse — that's where the reciter is.
            # Tracking the first verse of a 2-verse span completes
            # instantly ("الم") and its completion path overwrote the
            # span-aware last_emitted_text with the first verse's
            # with-bismillah text, blinding the residual check to the
            # span tail (measured: "للمتقين" after span 2:1-2 read as
            # novel content and cascaded two phantoms).
            track_verse = (
                self.db.get_verse(ref[0], a_end) if a_end != ref[1] else verse
            ) or verse
            if track_verse:
                self._enter_tracking(track_verse)
                self._retain_tail_after_commit()
                # A commit made DURING a final-flush cycle: the retained
                # tail is the SAME audio that just committed the verse, so
                # it must not "cover" the verse again and arm a phantom
                # next-verse advance (measured: 85:22 flush commit → tail
                # coverage 1.0 armed 86:1 at margin 0.31 → phantom
                # emitted; same for 103:3→104:1). Advancing unlocks only
                # after fresh SPEECH arrives (the reciter resuming).
                self.tracking_awaits_fresh_speech = final_flush
        return messages

    def _try_joined_window_redemption(self, text: str) -> list[dict] | None:
        """Pause-chopped mid-verse recovery: a final flush can land in the
        MIDDLE of a verse (the reciter paused), and the flush commit then
        resolves the half-window to some other short verse on weak text
        evidence. When speech resumes, the post-pause windows read as the
        true verse's TAIL — individually infeasible and blocked as
        non-continuations, so the wrong commit survives (measured: 36:76
        paused after four words; the flush window committed 77:36 at text
        0.55, and every later window led 36:76 but was blocked). Joining
        the flush window's text with the current window reconstructs the
        whole verse: if that joined reading decisively out-scores the
        suspect commit's own text evidence, roll the commit back and emit
        the redeemed verse."""
        rec = self.weak_flush_commit
        if not rec or len(text.split()) < 2:
            return None
        # identical windows repeat across trigger cycles while the reciter
        # pauses — don't re-run the joined retrieval for the same pair
        attempt = (rec["window_text"], text)
        if getattr(self, "_last_redemption_attempt", None) == attempt:
            return None
        self._last_redemption_attempt = attempt
        if self.last_emitted_ref != rec["ref"]:
            self.weak_flush_commit = None
            return None
        if self.total_samples_fed - rec["at"] > 15 * 16000:
            self.weak_flush_commit = None
            return None
        joined = (rec["window_text"] + " " + text).strip()
        jm = self.db.match_verse(
            joined, max_span=4, seeded_spans=True
        )
        if jm is None:
            return None
        if (jm["surah"], jm["ayah"]) == rec["ref"]:
            # the flush commit was right after all (possibly extended by a
            # continuation span) — stop watching it
            self.weak_flush_commit = None
            return None
        if (
            jm["score"] < 0.85
            or jm["score"] < rec["text_score"] + 0.15
        ):
            return None
        # the flush window must read as part of the redeemed verse, or the
        # join is a coincidence of the new window alone
        j_text = jm.get("text_clean") or (
            self.db.get_verse(jm["surah"], jm["ayah"]) or {}
        ).get("text_clean", "")
        if not j_text or partial_ratio(rec["window_text"], j_text) < 0.55:
            return None
        self.weak_flush_commit = None
        out: list[dict] = []
        rb = self._rollback_weak_commit("joined-window redemption", force=True)
        if rb:
            out.append(rb)
        effective = dict(jm)
        effective.setdefault("text_clean", j_text)
        confidence = min(0.95, float(jm["score"]))
        emit_msg = self._verse_match_message(effective, confidence)
        out.append(emit_msg)
        self._diag(
            type="commit",
            ref=ref_key(jm["surah"], jm["ayah"], jm.get("ayah_end")),
            reason="joined_window_redemption",
            confidence=round(confidence, 2),
        )
        self.prev_emitted_ref = self.last_emitted_ref
        self.prev_emitted_text = self.last_emitted_text
        self.prev_emitted_msg = self.last_emitted_msg
        self.last_emitted_msg = emit_msg
        self.last_emitted_ref = (jm["surah"], jm["ayah"])
        a_end = jm.get("ayah_end") or jm["ayah"]
        self.last_emitted_text = (
            self.db.span_text(jm["surah"], jm["ayah"], a_end)
            if a_end != jm["ayah"] else j_text
        )
        self.last_commit_evidence = _CommitEvidence(confidence, 1.0, True)
        self.pending_leader = None
        self.cycles_since_commit = 0
        track_verse = (
            self.db.get_verse(jm["surah"], a_end)
            or self.db.get_verse(jm["surah"], jm["ayah"])
        )
        if track_verse:
            self._enter_tracking(track_verse)
            self._retain_tail_after_commit()
        return out

    def _rival_texts(
        self, effective: dict, match: dict | None, ranked: list[dict],
        top_n: int = 3,
    ) -> list[str]:
        """text_clean of the strongest non-overlapping rivals — recorded at
        a tie-flush commit so the residual skip can recognize the rival's
        own disambiguating tail later."""
        eff_s = effective["surah"]
        eff_a = effective["ayah"]
        eff_end = effective.get("ayah_end") or eff_a
        pool = [r["candidate"] for r in ranked]
        pool.extend((match or {}).get("runners_up") or [])
        if match:
            pool.append(match)
        rivals: list[tuple[float, str]] = []
        for c in pool:
            a = c["ayah"]
            a_end = c.get("ayah_end") or a
            if c["surah"] == eff_s and a <= eff_end and a_end >= eff_a:
                continue
            t = c.get("text_clean") or (
                self.db.get_verse(c["surah"], a) or {}
            ).get("text_clean") or ""
            if t:
                rivals.append((float(c.get("score", 0.0)), t))
        rivals.sort(key=lambda x: -x[0])
        return [t for _s, t in rivals[:top_n]]

    def _best_rival_text_score(
        self, effective: dict, match: dict | None, ranked: list[dict]
    ) -> float:
        """Best text score among candidates naming a different,
        non-overlapping verse than `effective` — the measure of how
        ambiguous the current transcript still is."""
        eff_s = effective["surah"]
        eff_a = effective["ayah"]
        eff_end = effective.get("ayah_end") or eff_a
        pool = [r["candidate"] for r in ranked]
        pool.extend((match or {}).get("runners_up") or [])
        # The text match ITSELF is a rival when acoustic fusion promoted a
        # different verse to leader — and often the strongest one (measured:
        # fusion committed 96:6 on "والعصر ان الانس" while the text match
        # was the true 103:1-2 span, absent from ranked/runners-up).
        if match:
            pool.append(match)
        best = 0.0
        for c in pool:
            a = c["ayah"]
            a_end = c.get("ayah_end") or a
            if c["surah"] == eff_s and a <= eff_end and a_end >= eff_a:
                continue  # same verse or overlapping span
            best = max(best, float(c.get("score", 0.0)))
        return best

    def _stale_text_is_continuation(self, text: str, verse: dict) -> bool:
        """Does the stale-cycle transcript read as the opening of the verse
        AFTER the committed one? Then the commit was right and only the
        advance failed — retracting it would break normal multi-verse flow
        (measured: 114:5 correctly committed, 114:6's words produced 4
        stale cycles)."""
        if not text or len(text) < 3:
            return False
        nxt = self.db.get_next_verse(verse["surah"], verse["ayah"])
        if not nxt:
            return False
        nxt_text = nxt.get("text_clean") or ""
        if not nxt_text:
            return False
        n = min(len(text), len(nxt_text))
        return ratio(text, nxt_text[:n]) >= 0.5 or partial_ratio(text, nxt_text) >= 0.6

    def _best_rival_prefix_consistency(
        self, effective: dict, match: dict | None, ranked: list[dict], text: str
    ) -> float:
        """How well the window text reads as the HEAD of a different,
        longer verse: max over non-overlapping rivals of
        ratio(text, rival_text[:len(text)]). High values mean the leader
        cannot be committed live — the recitation may be mid-way through
        the rival (prefix-twin class: 3:2 is the exact opening of 2:255).

        Comparison is on bismillah-stripped texts: the bismillah opens
        every surah's with-bismillah variant, so 1:1 would otherwise read
        as the head of all 113 of them. It is a shared invocation, not
        distinguishing content (reference: quran_db.py:49-59 strips it for
        the same reason)."""
        text_s = _strip_bismillah(text)
        if not text_s:
            return 0.0
        eff_s = effective["surah"]
        eff_a = effective["ayah"]
        eff_end = effective.get("ayah_end") or eff_a
        pool = [r["candidate"] for r in ranked]
        pool.extend((match or {}).get("runners_up") or [])
        if match:
            pool.append(match)  # same rationale as _best_rival_text_score
        n = len(text_s)
        best = 0.0
        seen: set[tuple[int, int, int]] = set()
        for c in pool:
            a = c["ayah"]
            a_end = c.get("ayah_end") or a
            if c["surah"] == eff_s and a <= eff_end and a_end >= eff_a:
                continue  # same verse or overlapping span
            key = (c["surah"], a, a_end)
            if key in seen:
                continue
            seen.add(key)
            cand_text = c.get("text_clean") or self.db.span_text(
                c["surah"], a, a_end
            )
            cand_text = _strip_bismillah(cand_text or "")
            if not cand_text or len(cand_text) <= n:
                continue  # no continuation left to wait for
            best = max(best, ratio(text_s, cand_text[:n]))
        return best

    def _next_expected_verse(self) -> dict | None:
        """The verse expected to follow the last emission (span-aware:
        a span commit's continuation starts after its LAST ayah)."""
        if not self.last_emitted_ref:
            return None
        end_ayah = self.last_emitted_ref[1]
        if self.last_emitted_msg and self.last_emitted_msg.get(
            "surah"
        ) == self.last_emitted_ref[0]:
            end_ayah = (
                self.last_emitted_msg.get("ayah_end")
                or self.last_emitted_msg["ayah"]
            )
        return self.db.get_next_verse(self.last_emitted_ref[0], end_ayah)

    def _reads_as_continuation(self, text: str, residual: float) -> bool:
        """Refrain guard for the live residual skip: in refrain surahs
        consecutive verses fuzzy-match each other (109:2/3/4/5 share most
        of their words; 55's refrain repeats 31 times), so a window over
        genuinely NEW verses scores >0.7 against the just-emitted text and
        the whole cycle is skipped as leftover (measured: oracle multi_109
        lost 109:4-5 to back-to-back residual skips). If the window reads
        at least as well as the expected CONTINUATION, it must not be
        skipped — mixed leftover+onset windows still route through
        _strip_residual_prefix, whose next-verse break handles the prefix."""
        nxt = self._next_expected_verse()
        cont = (nxt or {}).get("text_clean") or ""
        if not cont:
            return False
        best = partial_ratio(text, cont)
        nxt2 = self.db.get_next_verse(nxt["surah"], nxt["ayah"])
        cont2 = (nxt2 or {}).get("text_clean") or ""
        if cont2:
            best = max(best, partial_ratio(text, cont + " " + cont2))
        return best >= 0.75 and best >= residual - 0.03

    def _strip_residual_prefix(self, text: str, min_score: float = 0.82) -> str:
        """Drop the longest leading word-prefix of `text` that reads as a
        fragment of the last emitted verse; return the new tail (reference:
        web/server.py:528-559)."""
        prev = self.last_emitted_text
        words = text.split()
        if not prev or not words:
            return text
        # Per-target length caps (ADVICE r3 discipline, extended): a
        # residual matched against the LAST emission alone cannot outgrow
        # that emission's text; a residual matched against the last TWO
        # emissions (a long verse committed early leaves a multi-window
        # remainder that reaches back past the next commit — measured:
        # 44:4's final word after span 44:1-4 + 44:5; 10:15's words 11-37
        # after 10:15 + 10:16) is capped by the CONCATENATED length, never
        # by less.
        prev_chars = len(prev.replace(" ", ""))
        concat = ""
        concat_chars = 0
        if self.prev_emitted_text:
            concat = (self.prev_emitted_text + " " + prev).strip()
            concat_chars = len(concat.replace(" ", ""))
        # Next-verse head guard: in refrain surahs consecutive verses share
        # words ("…الناس" ends every verse of 114), so the fuzzy residual
        # match can eat the NEXT verse's opening as "leftover" (measured:
        # "اله الناس" — all of 114:3 — stripped after span 114:1-2). If the
        # tail from position k reads as the next verse starting, stop
        # stripping there.
        nxt = self._next_expected_verse()
        nxt_text = (nxt or {}).get("text_clean") or ""
        best_k = 0
        for k in range(1, len(words) + 1):
            if nxt_text:
                tail = " ".join(words[k - 1 :])
                if ratio(tail[: len(nxt_text)], nxt_text) >= 0.85:
                    break
            # Tie-rival break (same rationale as the skip's passthrough):
            # after a coin-flip commit, a tail reading as the RECORDED
            # rival's content is its disambiguating evidence, not leftover.
            if self.tie_rival_texts:
                tail = " ".join(words[k - 1 :])
                if any(
                    partial_ratio(tail, rt) >= 0.9
                    for rt in self.tie_rival_texts
                ):
                    break
            prefix = " ".join(
                w for w in words[:k] if any("؀" <= ch <= "ۿ" for ch in w)
            )
            # A leading residual cannot be longer than the text it claims
            # to be leftover of — and partial_ratio flips direction once
            # the prefix outgrows its target (it aligns the SHORTER inside
            # the longer, so "prev ⊂ prefix" saturates at 1.0 and the
            # strip eats the new verse too; measured: 55:4 "علمه البيان"
            # vanished after "خلق الانسن").
            p_chars = len(prefix.replace(" ", ""))
            within_last = p_chars <= prev_chars * 1.15 + 2
            within_concat = bool(concat) and p_chars <= concat_chars * 1.15 + 2
            if not within_last and not within_concat:
                break
            # Decoder filler glyphs ("⁇") carry no lexical evidence — they
            # must not anchor a "this is new content" decision mid-residual
            # (measured: "ه ⁇ زكريا اذ" after emitting 19:2 stripped only
            # "ه" because ⁇ broke the chain, and the garbled remainder
            # clear-margined phantom 26:196).
            is_residual = (
                (within_last and partial_ratio(prefix, prev) >= min_score)
                or (within_concat and partial_ratio(prefix, concat) >= min_score)
            )
            if not prefix or is_residual:
                best_k = k
        return " ".join(words[best_k:])

    def _short_utterance_rescue(
        self, result: TranscribeResult, final_flush: bool = False
    ) -> list[dict]:
        """CTC rescue over short-verse candidates when the transcript is too
        short to retrieve on (tracker.ts:1055-1110)."""
        cfg = self.config
        if not (
            result.has_acoustic
            and len(result.token_ids) >= 2
            and self.cycles_since_commit > 1
        ):
            return []
        # Residual guard: a short fragment that reads as part of the verse
        # just emitted is leftover audio, not a new short verse (measured:
        # "شاء" — the tail of 16:90's "الفحشاء" — rescue-committed 56:31,
        # whose wrong last_emitted_text then let the rest of 16:90's tail
        # cascade into a second phantom at flush).
        text = result.text.strip()
        if (
            text
            and self.last_emitted_text
            and partial_ratio(text, self.last_emitted_text) > 0.7
        ):
            self._diag(type="silence_skip", mode="discovery",
                       reason="short rescue residual")
            return []
        shorts = self._short_verse_candidates()
        if not shorts:
            return []
        from tilawa_tpu_torch.pipeline.rerank import score_token_lists

        scores = score_token_lists(
            result.log_probs, result.t_valid,
            [c["token_ids"] for c in shorts],
            blank_id=result.log_probs.shape[-1] - 1,
        )
        order = np.argsort(scores)
        if not np.isfinite(scores[order[0]]) or not np.isfinite(scores[order[1]]):
            return []
        margin = float(scores[order[1]] - scores[order[0]])
        best = shorts[int(order[0])]
        ref = (best["surah"], best["ayah"])
        if margin < cfg.acoustic_clear_margin:
            return []
        if self.last_emitted_ref == ref:
            return []
        verse = self.db.get_verse(*ref)
        if not verse:
            return []
        # A single sub-5-char window is no basis for a commit: mid-
        # recitation the windows are leftover syllables (a fragment of
        # 80:3's tail rescue-committed 89:2 at margin 1.36), and at
        # utterance START a real model's first partial windows decode
        # garbage tokens that CTC-match some short verse with a huge
        # margin (measured: phantom 106:1 at margin 3.4 before 44:30).
        # Require the same short verse to lead two consecutive rescue
        # attempts — a genuinely recited short verse keeps leading.
        if self.rescue_leader and self.rescue_leader[0] == ref:
            self.rescue_leader = (ref, self.rescue_leader[1] + 1)
        else:
            self.rescue_leader = (ref, 1)
        # At final flush no more audio is coming, so repetition is
        # impossible — a 2-3 s clip of a tiny verse ("يس") produces ONE
        # rescue-eligible window and must still commit.
        if self.rescue_leader[1] < 2 and not final_flush:
            self._diag(type="silence_skip", mode="discovery",
                       reason=f"rescue needs repetition ({ref_key(*ref)})")
            return []
        confidence = min(0.85, 0.5 + margin)
        msg = self._verse_match_message(verse, confidence)
        self.prev_emitted_ref = self.last_emitted_ref
        self.prev_emitted_text = self.last_emitted_text
        self.prev_emitted_msg = self.last_emitted_msg
        self.last_emitted_msg = msg
        self.last_emitted_ref = ref
        self.last_emitted_text = verse["text_clean"]
        # Rescue commits are single-window guesses: a later CONFIDENT
        # different-surah commit must be able to supersede them no matter
        # how large the CTC margin looked on garbled tokens (the phantom
        # 106:1 scored margin 3.4 on start-of-utterance noise).
        self.last_commit_evidence = _CommitEvidence(
            confidence=confidence, acoustic_margin=margin, strong=False,
            rescue=True,
        )
        self.pending_leader = None
        self.rescue_leader = None
        self.cycles_since_commit = 0
        self.consecutive_auto_advances = 0
        self._diag(type="commit", ref=ref_key(*ref), reason="short_rescue",
                   confidence=round(confidence, 2),
                   acoustic_margin=round(margin, 3))
        self._enter_tracking(verse)
        return [msg]

    def _short_verse_candidates(self) -> list[dict]:
        if self._short_verse_cache is None:
            out = []
            for verse in self.db.verses:
                ids = self.token_store.ids_for_key(verse["surah"], verse["ayah"])
                if ids and len(ids) <= SHORT_VERSE_MAX_TOKENS:
                    out.append(
                        {"surah": verse["surah"], "ayah": verse["ayah"],
                         "token_ids": ids}
                    )
            self._short_verse_cache = out
        return self._short_verse_cache

    def _retrieve_candidates(
        self, text: str, match: dict | None, single_limit: int
    ) -> list[dict]:
        """Single verses + spans: match runners-up, fragment search, and
        span enumeration around the top refs (quran-db.ts retrieveCandidates
        equivalent on QuranDB primitives)."""
        from tilawa_tpu_torch.pipeline.candidates import make_span

        out: list[dict] = []
        seen: set = set()

        def add(cand: dict) -> None:
            key = (cand["surah"], cand["ayah"], cand.get("ayah_end") or cand["ayah"])
            if key not in seen:
                seen.add(key)
                out.append(cand)

        if match:
            add(dict(match))
            for ru in match.get("runners_up", []):
                verse = self.db.get_verse(ru["surah"], ru["ayah"])
                if verse:
                    c = dict(verse)
                    c["score"] = ru.get("score", 0.0)
                    add(c)
        for verse in self.db.search(text, top_k=single_limit):
            add(dict(verse))
        # Trigram seeds: the edit-ratio search buries long verses whose
        # HEAD matches a short query (mid-verse windows), while the trigram
        # index ranks them by shared rare character n-grams regardless of
        # length (measured: "قالا ربنا ظلم" is the exact opening of 7:23 —
        # trigram rank 0, absent from search top-200). Score them with the
        # fragment measure; the prefix-blend rescoring then lifts true
        # head-matches (quran-db.ts:586-605 ngram-pruned joint02 plays the
        # same role in the reference).
        for i in self.db.trigram_candidates(text, top_k=16):
            v = self.db.verses[i]
            c = dict(v)
            c["score"] = self.db.best_fragment_score(text, v)
            add(c)

        # Span enumeration around the top single refs.
        top_refs = [(c["surah"], c["ayah"]) for c in out[:24]]
        for surah, ayah in top_refs:
            max_ayah = len(self.db.get_surah(surah))
            for start in range(max(1, ayah - DISCOVERY_MAX_SPAN + 1), ayah + 1):
                for end in range(
                    max(ayah, start + 1),
                    min(max_ayah, start + DISCOVERY_MAX_SPAN - 1) + 1,
                ):
                    span = make_span(self.db, surah, start, end)
                    if span:
                        span["score"] = self.db.best_fragment_score(
                            text,
                            {"text_clean": span["text_clean"],
                             "text_clean_alt": span["text_clean"]},
                        )
                        add(span)
        return out

    def _rank_candidates(
        self, candidates: list[dict], result: TranscribeResult
    ) -> list[dict]:
        """Fusion ranking (tracker.ts:1694-1777): normalized-acoustic +
        text + length-fit weighted blend; weights shift when the text
        evidence is weak."""
        if not candidates:
            return []
        if not result.has_acoustic:
            ranked = [
                {
                    "candidate": c,
                    "acoustic_score": math.inf,
                    "acoustic_margin": 0.0,
                    "feasible": False,
                    "length_fit": 1.0,
                    "fusion_score": float(c.get("score", 0.0)),
                }
                for c in candidates
            ]
            ranked.sort(key=lambda r: r["candidate"].get("score", 0.0), reverse=True)
            return ranked

        observed_len = max(len(result.token_ids), 1)
        words = len(result.text.split())
        chars = len(result.text.replace(" ", ""))
        text_weak = (
            words <= DISCOVERY_LOW_CONFIDENCE_WORDS
            or chars <= DISCOVERY_LOW_CONFIDENCE_CHARS
        )
        tw = FUSION_LOW_TEXT_W if text_weak else FUSION_TEXT_W
        aw = FUSION_LOW_ACOUSTIC_W if text_weak else FUSION_ACOUSTIC_W
        lw = FUSION_LOW_LENGTH_W if text_weak else FUSION_LENGTH_W

        from tilawa_tpu_torch.pipeline.rerank import score_token_lists

        token_lists = [self.token_store.ids_for_candidate(c) for c in candidates]
        scores = score_token_lists(
            result.log_probs, result.t_valid, token_lists,
            blank_id=result.log_probs.shape[-1] - 1,
        )
        feasible_scores = scores[np.isfinite(scores)]
        if len(feasible_scores):
            lo, hi = float(feasible_scores.min()), float(feasible_scores.max())
        else:
            lo, hi = 0.0, 1.0
        rng = max(hi - lo, 1e-6)

        order = np.argsort(scores)
        sorted_scores = scores[order]
        ranked = []
        for rank_pos, idx in enumerate(order):
            c = candidates[int(idx)]
            s = float(scores[idx])
            feasible = math.isfinite(s)
            cand_len = max(len(token_lists[int(idx)]), 1)
            length_fit = min(cand_len, observed_len) / max(cand_len, observed_len)
            acoustic_fit = (1 - (s - lo) / rng) if feasible else 0.0
            fusion = min(
                1.0,
                float(c.get("score", 0.0)) * tw + acoustic_fit * aw + length_fit * lw,
            )
            nxt = (
                float(sorted_scores[rank_pos + 1])
                if rank_pos + 1 < len(sorted_scores) else s
            )
            ranked.append(
                {
                    "candidate": c,
                    "acoustic_score": s,
                    "acoustic_margin": (nxt - s) if feasible and math.isfinite(nxt)
                    else 0.0,
                    "feasible": feasible,
                    "length_fit": length_fit,
                    "fusion_score": fusion,
                }
            )
        ranked.sort(
            key=lambda r: (
                r["fusion_score"],
                r["candidate"].get("score", 0.0),
                -r["acoustic_score"] if math.isfinite(r["acoustic_score"]) else 0.0,
            ),
            reverse=True,
        )
        return ranked

    def _derive_effective_match(
        self,
        match: dict | None,
        ranked: list[dict],
        result: TranscribeResult,
        text_confidence_low: bool,
        final_flush: bool,
    ) -> tuple[dict | None, float, float, float]:
        """Text-vs-fusion arbitration (tracker.ts:1177-1330): fusion
        overrides weak text matches; span matches rebase onto the expected
        next ayah during live continuation."""
        cfg = self.config
        fusion_best = ranked[0] if ranked else None
        effective = dict(match) if match else None
        score = float(match["score"]) if match else 0.0
        acoustic_margin = fusion_best["acoustic_margin"] if fusion_best else 0.0
        length_fit = fusion_best["length_fit"] if fusion_best else 1.0

        def as_match(r: dict, floor: float = 0.0) -> tuple[dict, float]:
            c = dict(r["candidate"])
            s = max(
                float(c.get("score", 0.0)), r["fusion_score"], floor
            )
            c["score"] = s
            return c, s

        if match and fusion_best:
            match_key = ref_key(match["surah"], match["ayah"], match.get("ayah_end"))
            fb = fusion_best["candidate"]
            fusion_key = ref_key(fb["surah"], fb["ayah"], fb.get("ayah_end"))
            fusion_gap = fusion_best["fusion_score"] - match["score"]
            if fusion_key == match_key:
                score = max(score, fusion_best["fusion_score"],
                            float(fb.get("score", 0.0)))
            else:
                is_span = (fb.get("ayah_end") or fb["ayah"]) > fb["ayah"]
                should_override = (
                    match["score"] < cfg.verse_match_threshold + 0.10
                    or text_confidence_low
                    or fusion_gap >= FUSION_SELECTION_GAP
                    or (is_span and fusion_best["length_fit"] >= 0.7)
                )
                # A CONTINUATION match (the expected next verse, carrying
                # the continuation bonus) yields only to a rival with real
                # text evidence. Short windows structurally favor short
                # verses acoustically — the true next verse's tail hasn't
                # been recited yet, so its CTC score can't compete
                # (measured: 84:20 stole the commit from 2:3 on the
                # pause-flush window "الذين يؤمن", 2:3's exact head;
                # reference: server.py:914-945 strong-continuation rule).
                if (
                    should_override
                    and self._is_continuation(match["surah"], match["ayah"])
                    and not self._is_continuation(fb["surah"], fb["ayah"])
                    and float(fb.get("score", 0.0)) < 0.6
                ):
                    should_override = False
                if should_override:
                    effective, score = as_match(fusion_best, floor=0.5)
                    score = max(score, match["score"])
                    effective["score"] = score
                    acoustic_margin = fusion_best["acoustic_margin"]
                    length_fit = fusion_best["length_fit"]
        elif not match and fusion_best:
            effective, score = as_match(fusion_best)

        # Flush-time feasibility override: at final flush the audio is all
        # there is, so a text match whose token sequence cannot CTC-align
        # inside the observed frames (2L+1 > T, the reference's feasibility
        # contract — lib/ctc-rescore.ts:31-33) is physically ruled out.
        # Prefix-twin ties land here: the fragment matcher ties 2:255 with
        # 3:2 on their shared opening, but only 3:2 fits the frames.
        if (
            final_flush
            and effective is not None
            and fusion_best is not None
            and fusion_best["feasible"]
            and result.has_acoustic
        ):
            fb = fusion_best["candidate"]
            # Never override a CONTINUATION effective: a flush can fire on
            # a mid-verse breath pause where the expected next verse is
            # EXPECTEDLY infeasible (its tail hasn't been recited) — a
            # short verse that merely fits the frames must not steal the
            # commit (measured: 84:20 over 2:3 on the pause-flush window
            # "الذين يؤمن", 2:3's exact head). Without continuation context
            # the override stands: it is what resolves the fragment-tied
            # twins ("الله لا اله الا" ties 2:255/3:2/4:87/9:129 at 0.98;
            # only the short twin fits the recorded frames).
            eff_is_cont = self._is_continuation(
                effective["surah"], effective["ayah"]
            )
            if ref_key(effective["surah"], effective["ayah"], effective.get("ayah_end")) != ref_key(
                fb["surah"], fb["ayah"], fb.get("ayah_end")
            ) and fusion_best["fusion_score"] >= 0.6 and not eff_is_cont:
                eff_ids = self.token_store.ids_for_candidate(effective)
                if eff_ids and 2 * len(eff_ids) + 1 > result.t_valid:
                    effective, score = as_match(fusion_best)
                    acoustic_margin = fusion_best["acoustic_margin"]
                    length_fit = fusion_best["length_fit"]

        # Live span-to-next rebase: a broad span covering the expected next
        # ayah yields to a clearly-better nearby forward continuation.
        if effective and fusion_best and self.last_emitted_ref and not final_flush:
            next_ayah = self.last_emitted_ref[1] + 1
            eff_end = effective.get("ayah_end") or effective["ayah"]
            top = fusion_best["candidate"]
            broad_covers_next = (
                effective["surah"] == self.last_emitted_ref[0]
                and effective["ayah"] < next_ayah <= eff_end
            )
            top_is_nearby_forward = (
                top["surah"] == self.last_emitted_ref[0]
                and next_ayah < top["ayah"] <= self.last_emitted_ref[1] + 3
            )
            top_clearly_better = (
                (fusion_best["feasible"] or not result.has_acoustic)
                and fusion_best["length_fit"] >= 0.6
                and fusion_best["fusion_score"] >= score + 0.05
            )
            if broad_covers_next and top_is_nearby_forward and top_clearly_better:
                effective, score = as_match(fusion_best)
                acoustic_margin = fusion_best["acoustic_margin"]
                length_fit = fusion_best["length_fit"]

            # Span starting at/before the last emitted ayah but covering the
            # next: rebase to the next single verse (tracker.ts:1306-1330).
            eff_end = effective.get("ayah_end") or effective["ayah"]
            if (
                effective["surah"] == self.last_emitted_ref[0]
                and effective["ayah"] != next_ayah
                and effective["ayah"] <= next_ayah <= eff_end
            ):
                nxt = self.db.get_verse(effective["surah"], next_ayah)
                if nxt:
                    effective = dict(nxt)
                    effective["score"] = score
                    effective["ayah_end"] = None

        # Pull the selected candidate's own margin/length diagnostics.
        if effective:
            eff_key = ref_key(effective["surah"], effective["ayah"],
                              effective.get("ayah_end"))
            for r in ranked:
                c = r["candidate"]
                if ref_key(c["surah"], c["ayah"], c.get("ayah_end")) == eff_key:
                    acoustic_margin = r["acoustic_margin"]
                    length_fit = r["length_fit"]
                    break
        return effective, score, acoustic_margin, length_fit

    # ------------------------------------------------------------ tracking

    def _handle_tracking(self, final_flush: bool) -> list[dict]:
        cfg = self.config
        messages: list[dict] = []
        verse = self.tracking_verse
        if verse is None:
            return messages

        if not final_flush and self.new_audio_count < cfg.samples(
            cfg.tracking_trigger_sec
        ):
            if self.silence_samples >= cfg.samples(cfg.tracking_silence_timeout_sec):
                rb = self._rollback_weak_commit("tracking silence timeout")
                if rb:
                    messages.append(rb)
                self._exit_tracking("extended silence")
            return messages
        self.new_audio_count = 0

        result = self.transcribe(self.utterance_audio)
        self.last_tracking_result = result
        text = result.text.strip()
        if not text and not final_flush:
            return messages

        recognized = text.split()
        resume_from = max(self.tracking_last_word_idx, 0)
        _, matched = align_position(
            recognized, self.tracking_verse_words, resume_from, cfg.lookahead_words
        )
        primary_matched = list(matched)
        # Lexical evidence FOR THE PENDING verse, independent of which
        # verse is currently tracked (deferred_confirm keeps tracking the
        # old verse): the flush emit below requires it.
        if (
            self.tracking_pending_emission
            and self.pending_emission_message is not None
            and recognized
        ):
            pv = self.db.get_verse(
                self.pending_emission_message["surah"],
                self.pending_emission_message["ayah"],
            )
            if pv:
                _, pmatched = align_position(
                    recognized, pv["text_clean"].split(), 0,
                    cfg.lookahead_words,
                )
                # Same contiguity + ONSET discipline as the confirmation
                # rules: scattered stop-word hits ("قل"@0 + "ما"@4) are
                # retrieval noise, and a lone mid-verse word from tail
                # garbage is too (measured: two word_matches=1 cycles let
                # phantom 9:61 flush-emit after 9:60 completed — real
                # recitation of the next verse reads its OPENING words).
                if (
                    pmatched
                    and (pmatched[-1] - pmatched[0] + 1) <= len(pmatched) + 2
                    and pmatched[0] <= 2
                ):
                    self.pending_lexical_matches += len(pmatched)
        self.tracking_primary_matches += len(primary_matched)
        if primary_matched:
            # lexical progress on the committed verse vouches for it — it
            # was not a pause-chopped misread
            self.weak_flush_commit = None
        confirmed_pending = False

        # Fresh-audio confirmation of a deferred next-verse emission.
        if (
            self.tracking_pending_emission
            and has_strong_pending_prefix_evidence(
                matched, len(self.tracking_verse_words)
            )
            and self.total_samples_fed > self.samples_at_advance
        ):
            pending = self.pending_emission_message
            messages.extend(self._pending_gap_fill(pending))
            messages.append(pending)
            self._diag(
                type="pending_emission", action="confirmed",
                ref=f"{pending['surah']}:{pending['ayah']}",
                via="prefix_evidence", matched=list(matched),
                margin=self._finite(self.pending_emission_margin),
                fresh_samples=self.total_samples_fed - self.samples_at_advance,
            )
            self._clear_pending_emission()
            confirmed_pending = True

        acoustic_word = None
        if not matched:
            idx = self._acoustic_word_progress(result)
            if idx > self.tracking_last_word_idx:
                acoustic_word = idx
                matched = [idx]
        char_word = None
        if (
            not matched
            and len(text) >= 5
            and len(self.tracking_verse_words) >= 10
        ):
            idx = self._char_level_progress(text)
            if idx > self.tracking_last_word_idx:
                char_word = idx
                matched = [idx]

        advanced = bool(matched) and matched[-1] > self.tracking_last_word_idx
        self._diag(
            type="tracking_cycle",
            ref=ref_key(verse["surah"], verse["ayah"]),
            text_length=len(text),
            word_matches=len(primary_matched),
            acoustic_word=acoustic_word,
            char_word=char_word,
            advanced=advanced,
            final_flush=final_flush,
            pending=self.tracking_pending_emission,
        )

        if not advanced:
            self.stale_cycles += 1
            # A stale cycle only counts as misidentification EVIDENCE when
            # it carried substantive speech that matched nothing. Post-commit
            # windows routinely decode 1-2 chars (the retained tail cuts
            # through the current word), and 4 such cycles pass in ~1-2 s —
            # forcing a rollback on them retracted CORRECT commits
            # (measured: 110:3 and 23:115 both retracted on streaks of
            # text_length=1 decodes, then their own tails matched phantoms).
            if len(recognized) >= 3 and not primary_matched:
                self.stale_speech_cycles += 1
            if self.stale_cycles >= cfg.stale_cycle_limit or final_flush:
                self._diag(type="stale_exit",
                           ref=ref_key(verse["surah"], verse["ayah"]),
                           stale_cycles=self.stale_cycles)
                # The flush emit additionally requires that SOME cycle
                # lexically matched the pending verse's words — a pending
                # armed purely by coverage/CTC margin on the old verse's
                # tail audio is a guess, not evidence (measured: 10:17
                # flush-emitted after 10:16 with zero lexical matches
                # across every pending cycle).
                if (
                    final_flush
                    and self.tracking_pending_emission
                    and self.pending_emission_message is not None
                    and self.pending_emission_margin < cfg.advance_flush_strict_margin
                    and self.pending_lexical_matches > 0
                ):
                    pending = self.pending_emission_message
                    messages.append(pending)
                    self._diag(
                        type="commit",
                        ref=f"{pending['surah']}:{pending['ayah']}",
                        reason="final_flush_pending_emit",
                        confidence=pending.get("confidence"),
                    )
                    self._clear_pending_emission()
                    self._exit_tracking("final silence flush (pending emitted)")
                else:
                    # Real stale cycles = transcribed speech matched nothing
                    # in the committed verse for stale_cycle_limit cycles.
                    # That is misidentification evidence strong enough to
                    # retract even a confident commit — UNLESS the stale
                    # speech reads as the NEXT verse, which is the normal
                    # multi-verse flow with a failed advance (the reciter
                    # moved on; discovery will re-acquire). A silence flush
                    # alone never forces (the reciter may just have
                    # stopped).
                    force = (
                        self.stale_cycles >= cfg.stale_cycle_limit
                        and self.tracking_primary_matches == 0
                        and self.stale_speech_cycles >= 2
                        and not self._stale_text_is_continuation(text, verse)
                        # Span commits track the span's LAST verse; speech
                        # from an EARLIER span verse is expected, not
                        # misidentification (measured: mid-19:2 speech
                        # while tracking 19:3 of span 19:1-3 retracted a
                        # correct commit).
                        and not (
                            text
                            and self.last_emitted_text
                            and partial_ratio(text, self.last_emitted_text)
                            >= 0.6
                        )
                    )
                    rb = self._rollback_weak_commit(
                        "final silence flush" if final_flush else "stale tracking",
                        force=force,
                    )
                    if rb:
                        messages.append(rb)
                    self._exit_tracking(
                        "final silence flush" if final_flush else "stale tracking"
                    )
            return messages

        self.stale_cycles = 0
        # Only real lexical alignment protects the commit from the
        # misidentification rollback: the acoustic/char fallbacks fire on
        # near-empty windows (measured: adv=True on 1-char decodes right
        # after a phantom commit) and must keep driving word_progress
        # without vouching for the verse identity.
        if primary_matched:
            # One scattered word per cycle is not established progress — a
            # lone "ربك" matching the WRONG twin's "ربكم" immunized a
            # coin-flip flush commit against the superseded rollback.
            # Two matches in one cycle, or a match at the verse head, is.
            if len(primary_matched) >= 2 or primary_matched[0] <= 1:
                self.tracking_progress_established = True
            if primary_matched[-1] > self.tracking_lexical_word_idx:
                self.tracking_lexical_word_idx = primary_matched[-1]
            if primary_matched[0] < self.tracking_min_lexical_idx:
                self.tracking_min_lexical_idx = primary_matched[0]
        self.tracking_last_word_idx = matched[-1]
        word_pos = self.tracking_last_word_idx + 1
        total_words = len(self.tracking_verse_words)
        coverage = round(word_pos / total_words, 3)
        completion_target = math.ceil(total_words * cfg.tracking_completion_coverage)
        completed_enough = word_pos >= completion_target
        final_word_reached = self.tracking_last_word_idx >= total_words - 1
        # Lexical-only coverage: the acoustic/char fallbacks saturate on
        # short verses fed leftover audio, so they may drive word_progress
        # display but never CONFIRM a deferred emission (measured: 100:1's
        # tail audio "confirmed" phantom 100:2 then 100:3 through acoustic
        # word progress alone).
        # A single stop-word landing at a high index must not read as
        # completion: the acoustic fallback inflates resume_from, and the
        # greedy aligner then matches one ubiquitous word deep into the
        # verse (measured: mid-10:15 audio pushed pending 10:16 to
        # acoustic_word 10, a lone "من" matched w14 of 18, and lex_completed
        # "confirmed" the phantom). Require a body of lexical matches
        # proportional to the verse, not just the furthest index.
        lex_match_floor = max(2, completion_target // 3)
        # ... and the verse's ONSET must have been seen: one scattered
        # stop-word per cycle accumulates past any count floor (measured:
        # 10 pending cycles of mid-10:15 audio matched 10:16 only at
        # w14/w16 — "من"/"قبله"-class words — never its opening). A verse
        # actually being recited matches an early word in some cycle.
        lex_completed = (
            self.tracking_lexical_word_idx + 1 >= completion_target
            and self.tracking_primary_matches >= lex_match_floor
            and self.tracking_min_lexical_idx <= 2
        )

        # Coverage-confirmed deferred emission (lexical evidence only).
        if (
            lex_completed
            and self.tracking_pending_emission
            and self.pending_emission_message is not None
        ):
            pending = self.pending_emission_message
            messages.extend(self._pending_gap_fill(pending))
            messages.append(pending)
            self._diag(type="pending_emission", action="confirmed",
                       ref=f"{pending['surah']}:{pending['ayah']}",
                       via="lex_completed",
                       lexical_word_idx=self.tracking_lexical_word_idx,
                       margin=self._finite(self.pending_emission_margin),
                       fresh_samples=self.total_samples_fed - self.samples_at_advance)
            self._clear_pending_emission()
            confirmed_pending = True

        if not self.tracking_pending_emission:
            messages.append(
                {
                    "type": "word_progress",
                    "surah": verse["surah"],
                    "ayah": verse["ayah"],
                    "word_index": word_pos,
                    "total_words": total_words,
                    "matched_indices": matched,
                }
            )

        if completed_enough and confirmed_pending and not final_word_reached:
            # Anti-cascade: never arm a second advance in the same cycle a
            # pending emission just confirmed, unless the final word landed.
            self._diag(type="advance_decision", action="blocked",
                       reason="pending confirmed before final word",
                       from_ref=ref_key(verse["surah"], verse["ayah"]), to_ref=None)
            return messages

        if completed_enough:
            if (
                not (self.last_commit_evidence and self.last_commit_evidence.strong)
                and not self.tracking_progress_established
            ):
                self._exit_tracking("weak completion")
                return messages
            messages.extend(
                self._advance(verse, word_pos, total_words, coverage,
                              completion_target, final_word_reached)
            )
        return messages

    def _advance(
        self, verse: dict, word_pos: int, total_words: int, coverage: float,
        completion_target: int, final_word_reached: bool,
    ) -> list[dict]:
        """Completion handling: relative CTC evidence gate (next-verse
        prefix vs current-verse suffix), deferred-emission arming with a
        rollback snapshot, and the three next_verse_emit_mode flavors."""
        cfg = self.config
        messages: list[dict] = []
        current_ref = (verse["surah"], verse["ayah"])
        current_ids = self.token_store.ids_for_key(*current_ref) or []
        next_verse = self.db.get_next_verse(*current_ref)
        advance_ok = True
        early_advance_ok = True
        advance_margin = math.inf
        acoustic = self.last_tracking_result
        next_ids = (
            self.token_store.ids_for_key(next_verse["surah"], next_verse["ayah"])
            if next_verse else None
        ) or []

        if next_verse and acoustic and acoustic.has_acoustic and current_ids and next_ids:
            n = cfg.advance_prefix_tokens
            suffix = current_ids[-min(n, len(current_ids)):]
            prefix = next_ids[: min(n, len(next_ids))]
            from tilawa_tpu_torch.pipeline.rerank import score_token_lists

            s = score_token_lists(
                acoustic.log_probs, acoustic.t_valid, [suffix, prefix],
                blank_id=acoustic.log_probs.shape[-1] - 1,
            )
            suffix_score, prefix_score = float(s[0]), float(s[1])
            if not (math.isfinite(suffix_score) and math.isfinite(prefix_score)):
                advance_ok = False
            else:
                advance_margin = prefix_score - suffix_score
                advance_ok = advance_margin < cfg.advance_relative_margin
                early_advance_ok = (
                    True if final_word_reached
                    else advance_margin < cfg.advance_flush_strict_margin
                )

        if not final_word_reached and not early_advance_ok:
            self._diag(
                type="advance_decision", action="wait",
                reason="coverage reached without final word or next-prefix evidence",
                from_ref=ref_key(*current_ref),
                to_ref=ref_key(next_verse["surah"], next_verse["ayah"])
                if next_verse else None,
                coverage=coverage, margin=self._finite(advance_margin),
            )
            return messages

        # Completing the PENDING verse itself is its confirmation: this
        # path only runs with completion coverage plus final-word or
        # next-prefix acoustic evidence, so reverting the deferred
        # emission in _exit_tracking would silently swallow a verse the
        # reciter finished (measured: 95:2 armed -> tracked to completion
        # -> dropped on its own "verse complete" exit; emissions skipped
        # it while the tracker moved on to 95:3).
        if (
            self.tracking_pending_emission
            and self.pending_emission_message is not None
            and (
                self.pending_emission_message["surah"],
                self.pending_emission_message["ayah"],
            ) == current_ref
            # "Completed" implies the verse was actually SPOKEN: demand at
            # least ~0.35 s of fresh audio per verse word since arming
            # (measured: phantom 84:24 — 3 words — "completed" on 0.6 s of
            # tail garbage; genuine completions ride seconds of speech).
            and (
                self.total_samples_fed - self.samples_at_advance
                >= cfg.samples(0.35 * max(len(self.tracking_verse_words), 1))
            )
            # Completion driven PURELY by the acoustic/char fallbacks is a
            # guess, not evidence the pending verse was recited: on short
            # verses the fallbacks saturate on leftover audio (measured:
            # 100:1's tail "completed" pending 100:2 then 100:3 with zero
            # lexical matches — word_matches=0 on every cycle). Accept the
            # completion only with lexical evidence OR a negative arming
            # margin — the next verse's prefix scored acoustically BETTER
            # than the current verse's suffix at advance time, which
            # leftover audio of the old verse cannot produce (measured:
            # genuine 95:2 armed at margin -6.5; phantom 100:2 at +2.2).
            and (
                self.tracking_progress_established
                or (
                    self.pending_emission_margin < 0.0
                    # ... and the reciter is actually still speaking: a
                    # shallow negative margin during the trailing silence
                    # confirmed phantom 84:24 (margin -0.32) off tail
                    # garbage, then gap-filled 84:23 on top. Genuine
                    # continuations (95:2 at -6.5, 77:5 at -0.16) ride
                    # live speech.
                    and self.silence_samples
                    < cfg.samples(cfg.final_silence_sec)
                )
            )
        ):
            pending = self.pending_emission_message
            messages.extend(self._pending_gap_fill(pending))
            messages.append(pending)
            self._diag(
                type="pending_emission", action="confirmed",
                ref=f"{pending['surah']}:{pending['ayah']}",
                reason="completed while pending",
            )
            self._clear_pending_emission()
        self.last_emitted_ref = current_ref
        self.last_emitted_text = verse["text_clean"]
        self._exit_tracking(
            "verse complete" if final_word_reached
            else "near-complete with next prefix"
        )

        if not next_verse:
            return messages
        if not advance_ok:
            self._diag(
                type="advance_decision", action="blocked",
                reason="advance margin failed",
                from_ref=ref_key(*current_ref),
                to_ref=ref_key(next_verse["surah"], next_verse["ayah"]),
                margin=self._finite(advance_margin),
            )
            return messages

        if getattr(self, "tracking_awaits_fresh_speech", False):
            self._diag(
                type="advance_decision", action="blocked",
                reason="flush-commit tail cannot arm an advance",
                from_ref=ref_key(*current_ref),
                to_ref=ref_key(next_verse["surah"], next_verse["ayah"]),
            )
            return messages
        # Arm deferred emission with a rollback snapshot.
        self.pre_advance_snapshot = {
            "emitted_ref": self.last_emitted_ref,
            "emitted_text": self.last_emitted_text,
            "emitted_msg": self.last_emitted_msg,
            "prev_emitted_ref": self.prev_emitted_ref,
            "prev_emitted_text": self.prev_emitted_text,
            "prev_emitted_msg": self.prev_emitted_msg,
            "commit_evidence": self.last_commit_evidence,
        }
        self.pending_emission_message = self._verse_match_message(next_verse, 0.99)
        self.tracking_pending_emission = True
        self.samples_at_advance = self.total_samples_fed
        self.pending_emission_margin = advance_margin
        self._diag(
            type="advance_decision", action="armed",
            reason="final word reached" if final_word_reached
            else "completion coverage reached",
            from_ref=ref_key(*current_ref),
            to_ref=ref_key(next_verse["surah"], next_verse["ayah"]),
            coverage=coverage, margin=self._finite(advance_margin),
        )
        self._diag(type="pending_emission", action="armed",
                   ref=ref_key(next_verse["surah"], next_verse["ayah"]),
                   margin=self._finite(advance_margin), fresh_samples=0)

        self.prev_emitted_ref = current_ref
        self.prev_emitted_text = self.last_emitted_text
        self.prev_emitted_msg = self.last_emitted_msg
        self.last_emitted_ref = (next_verse["surah"], next_verse["ayah"])
        self.last_emitted_text = next_verse["text_clean"]
        self.last_emitted_msg = self.pending_emission_message
        self.last_commit_evidence = _CommitEvidence(0.99, 1.0, True)
        self._enter_tracking(next_verse)
        self._retain_tail_after_commit()
        self.consecutive_auto_advances += 1

        if cfg.next_verse_emit_mode == "candidate_until_confirmed":
            messages.append(
                {
                    "type": "verse_candidate",
                    "candidates": [
                        {"surah": next_verse["surah"], "ayah": next_verse["ayah"],
                         "ayah_end": None, "confidence": 0.99, "rank": 1,
                         "source": "tracking"}
                    ],
                    "stable": True,
                    "final_flush": False,
                }
            )
        elif cfg.next_verse_emit_mode == "immediate_on_completion":
            messages.append(self.pending_emission_message)
            self._clear_pending_emission()

        # Sustained auto-advances degrade to weak so a stale exit triggers
        # rediscovery instead of persisting (tracker.ts:997-1002).
        if self.consecutive_auto_advances >= 5:
            self.last_commit_evidence = dataclasses.replace(
                self.last_commit_evidence, strong=False
            )
        return messages

    # ---------------------------------------------------- progress fallbacks

    def _acoustic_word_progress(self, result: TranscribeResult) -> int:
        """Best word index by CTC-scoring verse word prefixes
        (tracker.ts:1675-1692)."""
        verse = self.tracking_verse
        if verse is None or not result.has_acoustic:
            return -1
        words = self.tracking_verse_words
        start = self.tracking_last_word_idx + 1
        upto = min(len(words), start + 6)
        prefixes = []
        idxs = []
        for i in range(start, upto):
            ids = self.token_store.ids_for_text(" ".join(words[: i + 1]))
            if ids:
                prefixes.append(ids)
                idxs.append(i)
        if not prefixes:
            return -1
        from tilawa_tpu_torch.pipeline.rerank import choose_longest_stable_prefix

        best = choose_longest_stable_prefix(
            result.log_probs, result.t_valid, prefixes,
            tolerance=self.config.tracking_prefix_tolerance,
            blank_id=result.log_probs.shape[-1] - 1,
        )
        return idxs[best] if best is not None else -1

    def _char_level_progress(self, text: str) -> int:
        """Sliding char-window progress fallback (tracker.ts:1779-1822)."""
        verse = self.tracking_verse
        if verse is None:
            return -1
        words = self.tracking_verse_words
        joined = verse["text_clean"]
        no_space_text = text.replace(" ", "")
        no_space_joined = joined.replace(" ", "")
        if len(no_space_text) < 3 or len(no_space_text) >= len(no_space_joined):
            return -1
        best_score, best_end = 0.0, -1
        # char end offsets per word
        ends = []
        acc = 0
        for w in words:
            acc += len(w)
            ends.append(acc)
        win = len(no_space_text)
        for start in range(0, len(no_space_joined) - win + 1):
            s = ratio(no_space_text, no_space_joined[start:start + win])
            if s > best_score:
                best_score = s
                best_end = start + win
        if best_score < 0.6 or best_end < 0:
            return -1
        for i, e in enumerate(ends):
            if e >= best_end:
                return i
        return len(words) - 1

    # ------------------------------------------------------------- plumbing

    def _dropped_chain_for(
        self, surah: int, ayah: int, require_bottom_after: int | None = None,
        max_len: int = 3,
    ) -> list[tuple[int, int]]:
        """Maximal consecutive run of recently-DROPPED pending verses
        ending immediately before `surah:ayah`, ascending. Husary-pace
        recitation can drop two pendings back to back (77:3 AND 77:4),
        so the fill must walk a chain, not a single slot."""
        window = self.config.samples(12.0)
        fresh = {
            r for r, at in self.dropped_pendings
            if self.total_samples_fed - at <= window and r[0] == surah
        }
        chain: list[tuple[int, int]] = []
        x = ayah - 1
        while (
            (surah, x) in fresh
            and (surah, x) not in self.emitted_refs_utterance
            and len(chain) < max_len
        ):
            chain.append((surah, x))
            x -= 1
        chain.reverse()
        if not chain:
            return []
        if (
            require_bottom_after is not None
            and chain[0][1] != require_bottom_after + 1
        ):
            return []
        return chain

    def _pending_gap_fill(self, pending: dict) -> list[dict]:
        """Gap-fill at pending-CONFIRMATION time: dropped pending verses
        X (or X-1, X) whose successor is confirming right now are holes
        the confirmation itself proves (measured: 91:3 dropped by the
        stricter completed-while-pending rule, 91:4 confirmed via prefix
        evidence, and the late discovery re-commit landed out of order;
        multi_077 dropped BOTH 77:3 and 77:4 before 77:5 confirmed)."""
        chain = self._dropped_chain_for(pending["surah"], pending["ayah"])
        out: list[dict] = []
        for (ds, da) in chain:
            gap_verse = self.db.get_verse(ds, da)
            if not gap_verse:
                continue
            self._diag(type="commit", ref=ref_key(ds, da),
                       reason="gap_fill_on_pending_confirm", confidence=0.72)
            out.append(self._verse_match_message(gap_verse, 0.72))
        if chain:
            self.dropped_pendings = [
                e for e in self.dropped_pendings if e[0] not in set(chain)
            ]
        return out

    def _verse_match_message(self, verse: dict, confidence: float) -> dict:
        full = self.db.get_verse(verse["surah"], verse["ayah"]) or verse
        return {
            "type": "verse_match",
            "surah": verse["surah"],
            "ayah": verse["ayah"],
            "ayah_end": verse.get("ayah_end"),
            "verse_text": full.get("text_uthmani") or full.get("text_clean", ""),
            "surah_name": full.get("surah_name", ""),
            "confidence": round(confidence, 2),
            "surrounding_verses": self._surrounding(verse["surah"], verse["ayah"]),
        }

    def _surrounding(self, surah: int, ayah: int) -> list[dict]:
        return [
            {"surah": v["surah"], "ayah": v["ayah"],
             "text": v.get("text_uthmani") or v.get("text_clean", "")}
            for v in self.db.get_surah(surah)
            if abs(v["ayah"] - ayah) <= SURROUNDING_CONTEXT
        ]

    def _enter_tracking(self, verse: dict) -> None:
        self.tracking_awaits_fresh_speech = False
        self.tracking_verse = verse
        self.tracking_verse_words = verse["text_clean"].split()
        self.tracking_last_word_idx = -1
        self.tracking_lexical_word_idx = -1
        self.tracking_min_lexical_idx = 10**9
        self.tracking_progress_established = False
        self.tracking_primary_matches = 0
        self.stale_speech_cycles = 0
        self.stale_cycles = 0
        self.last_tracking_result = None

    def _exit_tracking(self, reason: str) -> None:
        if self.tracking_pending_emission and self.pre_advance_snapshot:
            snap = self.pre_advance_snapshot
            if self.pending_emission_message:
                self.dropped_pendings.append((
                    (
                        self.pending_emission_message["surah"],
                        self.pending_emission_message["ayah"],
                    ),
                    self.total_samples_fed,
                ))
                del self.dropped_pendings[:-4]
            self.last_emitted_ref = snap["emitted_ref"]
            self.last_emitted_text = snap["emitted_text"]
            # Restore the message too: after a dropped pending emission
            # last_emitted_msg otherwise keeps describing the
            # never-confirmed NEXT verse, so the span-remainder dedup and
            # _strip_residual_prefix guard compute emitted_end one ayah
            # too far (ADVICE r2).
            self.last_emitted_msg = snap["emitted_msg"]
            self.prev_emitted_ref = snap["prev_emitted_ref"]
            self.prev_emitted_text = snap["prev_emitted_text"]
            self.prev_emitted_msg = snap["prev_emitted_msg"]
            self.last_commit_evidence = snap["commit_evidence"]
            self.consecutive_auto_advances = 0
            self._diag(type="pending_emission", action="dropped",
                       ref=None, reason=reason)
        self._clear_pending_emission()
        self.tracking_verse = None
        self.tracking_verse_words = []
        self.tracking_last_word_idx = -1
        self.tracking_lexical_word_idx = -1
        self.tracking_min_lexical_idx = 10**9
        self.tracking_progress_established = False
        self.tracking_primary_matches = 0
        self.stale_speech_cycles = 0
        self.stale_cycles = 0
        self.last_tracking_result = None

    def _clear_pending_emission(self) -> None:
        self.tracking_pending_emission = False
        self.pending_emission_message = None
        self.pending_emission_margin = math.inf
        self.pending_lexical_matches = 0
        self.pre_advance_snapshot = None

    def _rollback_weak_commit(self, reason: str, force: bool = False) -> dict | None:
        """Retract the last commit and return a verse_rollback message
        (None when no rollback applies).

        force=True is the misidentification path (reference:
        web/server.py:625-675 revert; tracker.ts:1862-1877): the tracker
        heard `stale_cycle_limit` cycles of real speech that matched
        nothing in the committed verse — direct evidence the commit was
        wrong no matter how confident it looked on the partial discovery
        window (measured: 69:28 committed at 0.99 on the 3-word prefix of
        111:2, 96:6 on the opening of 103:1-3). Weak-only (force=False)
        still governs the silence paths, where zero progress just means
        the reciter stopped."""
        if not force and (
            self.last_commit_evidence and self.last_commit_evidence.strong
        ):
            return None
        if self.tracking_progress_established or self.last_emitted_ref is None:
            return None
        retracted = self.last_emitted_msg
        self.last_emitted_ref = self.prev_emitted_ref
        self.last_emitted_text = self.prev_emitted_text
        # Restore the PREVIOUS verse's message so emitted_end-based
        # consumers (span-remainder dedup, residual-prefix guard) describe
        # the verse last_emitted_ref now points to (ADVICE r2).
        self.last_emitted_msg = self.prev_emitted_msg
        self.last_commit_evidence = None
        # the rolled-back commit may have displaced a watched weak flush
        # commit that is now the live emission again — revive its record
        # so joined-window redemption still applies
        if (
            self.prev_weak_flush_commit
            and self.prev_weak_flush_commit["ref"] == self.last_emitted_ref
        ):
            self.weak_flush_commit = self.prev_weak_flush_commit
        self.prev_weak_flush_commit = None
        self._diag(
            type="rollback", reason=reason,
            restored_ref=ref_key(*self.prev_emitted_ref)
            if self.prev_emitted_ref else None,
        )
        if retracted is None:
            return None
        return {
            "type": "verse_rollback",
            "surah": retracted["surah"],
            "ayah": retracted["ayah"],
            "ayah_end": retracted.get("ayah_end"),
            "reason": reason,
        }

    def _retain_tail_after_commit(self) -> None:
        """Keep only the last ~0.75-2 s of audio after a strong commit so
        the next verse's onset survives the trim (tracker.ts:1879-1892)."""
        if self.last_commit_evidence and self.last_commit_evidence.strong:
            keep_sec = (
                self.config.tail_after_pending_advance_sec
                if self.tracking_pending_emission
                else self.config.tail_after_commit_sec
            )
            keep = min(len(self.utterance_audio), self.config.samples(keep_sec))
            self.utterance_audio = self.utterance_audio[-keep:] if keep else (
                np.zeros(0, dtype=np.float32)
            )
        self.new_audio_count = 0
        self.silence_samples = 0
        self.utterance_has_speech = len(self.utterance_audio) > 0
        self.did_final_flush = False

    def _reset_utterance(self) -> None:
        self.emitted_refs_utterance = set()
        self.utterance_audio = np.zeros(0, dtype=np.float32)
        self.new_audio_count = 0
        self.silence_samples = 0
        self.utterance_has_speech = False
        self.did_final_flush = False
        self.pending_leader = None
        self.rescue_leader = None
        self.last_leader_candidate = None
        self.tie_rival_texts = []
        self.last_raw_transcript = None
        self.hypothesis.reset()

    def _is_continuation(self, surah: int, ayah: int) -> bool:
        if not self.last_emitted_ref:
            return False
        return (
            surah == self.last_emitted_ref[0]
            and self.last_emitted_ref[1] + 1 <= ayah <= self.last_emitted_ref[1] + 3
        )

    @staticmethod
    def _finite(x: float) -> float | None:
        return round(x, 3) if math.isfinite(x) else None

    def _diag(self, **event) -> None:
        if self.on_diagnostic:
            self.on_diagnostic(event)
