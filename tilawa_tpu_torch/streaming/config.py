"""Streaming configuration: typed knobs, presets, clamp validation.

Parity with the reference's StreamingConfig surface (reference:
web/frontend/src/lib/types.ts:126-312 — 24 runtime knobs, three presets
conservative/balanced/aggressiveAdvance, and a clamp-validating
normalizer applied to any partial override), plus the
StreamingHypothesis transition parameters with their env-var overrides
(reference: lib/tracker.ts:443-481, STREAMING_HYPOTHESIS_* vars).
"""

from __future__ import annotations

import dataclasses
import os

SAMPLE_RATE = 16000

NEXT_VERSE_EMIT_MODES = (
    "deferred_confirm",
    "candidate_until_confirmed",
    "immediate_on_completion",
)


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    audio_chunk_ms: float = 300
    discovery_trigger_sec: float = 2.0
    tracking_trigger_sec: float = 0.5
    discovery_max_window_sec: float = 30.0
    tracking_max_window_sec: float = 30.0
    tail_after_commit_sec: float = 2.0
    tail_after_pending_advance_sec: float = 0.5
    final_silence_sec: float = 1.2
    silence_rms_threshold: float = 0.005
    first_match_threshold: float = 0.75
    verse_match_threshold: float = 0.45
    discovery_repeat_cycles: int = 2
    acoustic_clear_margin: float = 0.12
    acoustic_continuation_margin: float = 0.08
    decode_stability_enabled: bool = True
    decode_stability_ratio: float = 0.70
    non_continuation_jump_threshold: float = 0.65
    next_verse_emit_mode: str = "deferred_confirm"
    tracking_completion_coverage: float = 0.95
    tracking_prefix_tolerance: float = 0.12
    lookahead_words: int = 5
    stale_cycle_limit: int = 4
    tracking_silence_timeout_sec: float = 4.0
    advance_relative_margin: float = 3.0
    advance_prefix_tokens: int = 15
    advance_flush_strict_margin: float = 0.5

    def samples(self, seconds: float) -> int:
        return max(1, round(SAMPLE_RATE * seconds))


CONSERVATIVE = StreamingConfig()

BALANCED = dataclasses.replace(
    CONSERVATIVE,
    audio_chunk_ms=150,
    tracking_trigger_sec=0.25,
    tracking_max_window_sec=12,
    tail_after_commit_sec=0.75,
    next_verse_emit_mode="candidate_until_confirmed",
    tracking_completion_coverage=0.82,
    acoustic_continuation_margin=0.06,
    advance_relative_margin=3.5,
)

AGGRESSIVE_ADVANCE = dataclasses.replace(
    BALANCED,
    discovery_trigger_sec=1.5,
    tracking_completion_coverage=0.85,
    discovery_repeat_cycles=1,
    acoustic_continuation_margin=0.04,
    advance_relative_margin=4.0,
    advance_flush_strict_margin=1.0,
)

STREAMING_PRESETS = {
    "conservative": CONSERVATIVE,
    "balanced": BALANCED,
    "aggressiveAdvance": AGGRESSIVE_ADVANCE,
    "aggressive_advance": AGGRESSIVE_ADVANCE,
}

DEFAULT_STREAMING_CONFIG = BALANCED


def _clamp(v: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, float(v)))


# field -> (lo, hi, round-to-int) — the clamp contract of
# normalizeStreamingConfig (types.ts:279-312).
_CLAMPS: dict[str, tuple[float, float, bool]] = {
    "audio_chunk_ms": (100, 1000, False),
    "discovery_trigger_sec": (0.5, 6, False),
    "tracking_trigger_sec": (0.15, 3, False),
    "discovery_max_window_sec": (3, 45, False),
    "tracking_max_window_sec": (3, 45, False),
    "tail_after_commit_sec": (0, 6, False),
    "tail_after_pending_advance_sec": (0, 3, False),
    "final_silence_sec": (0.3, 5, False),
    "silence_rms_threshold": (0.001, 0.05, False),
    "first_match_threshold": (0.1, 0.99, False),
    "verse_match_threshold": (0.1, 0.99, False),
    "discovery_repeat_cycles": (1, 5, True),
    "acoustic_clear_margin": (0, 1, False),
    "acoustic_continuation_margin": (0, 1, False),
    "decode_stability_ratio": (0, 1, False),
    "non_continuation_jump_threshold": (0.1, 0.99, False),
    "tracking_completion_coverage": (0.5, 1, False),
    "tracking_prefix_tolerance": (0, 1, False),
    "lookahead_words": (1, 15, True),
    "stale_cycle_limit": (1, 12, True),
    "tracking_silence_timeout_sec": (0.5, 10, False),
    "advance_relative_margin": (-2, 8, False),
    "advance_prefix_tokens": (3, 60, True),
    "advance_flush_strict_margin": (-2, 8, False),
}


def normalize_streaming_config(
    partial: dict | StreamingConfig | None = None,
    base: StreamingConfig = DEFAULT_STREAMING_CONFIG,
) -> StreamingConfig:
    """Merge a partial override onto `base` and clamp every knob into its
    valid range; unknown keys are ignored, bad emit modes fall back."""
    if isinstance(partial, StreamingConfig):
        merged = dataclasses.asdict(partial)
    else:
        merged = dataclasses.asdict(base)
        for k, v in (partial or {}).items():
            if k in merged:
                merged[k] = v
    out = {}
    for k, v in merged.items():
        if k in _CLAMPS:
            lo, hi, to_int = _CLAMPS[k]
            v = _clamp(v, lo, hi)
            if to_int:
                v = round(v)
        elif k == "decode_stability_enabled":
            v = bool(v)
        elif k == "next_verse_emit_mode":
            if v not in NEXT_VERSE_EMIT_MODES:
                v = DEFAULT_STREAMING_CONFIG.next_verse_emit_mode
        out[k] = v
    return StreamingConfig(**out)


# ---------------------------------------------------------------------------
# StreamingHypothesis transition parameters (tracker.ts:443-481)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HypothesisParams:
    surah_jump_high_confidence: float = -0.35
    # -1.6 per the round-3 offline sweep (v3 Viterbi 0.864 -> 0.872,
    # v1/v2 unchanged; plateaus by -1.6). Garbage cycles on real runs are
    # usually cross-surah, so a stiffer jump penalty is real-run-safe.
    surah_jump: float = -1.6
    same_ayah: float = 0.15
    next_ayah: float = 0.35
    small_forward_per_ayah: float = -0.15
    backward: float = -1.0
    far_forward: float = -0.65
    # Cost scale for SKIPPING a candidate cycle entirely in the final
    # Viterbi (garbage-cycle exclusion):
    # cost = max(0.05, skip_scale * top_relative_emission), so
    # low-confidence noise cycles are near-free to drop while confident
    # cycles must be explained by the path. 1.0 reproduces the round-2
    # measured behavior (oracle Viterbi v1/v2/v3 0.818/0.791/0.784).
    skip_scale: float = 1.0
    # Confidence level above which skipping a cycle starts to cost:
    # skip_cost = max(0.05, skip_scale * (top_confidence - skip_offset)).
    # Decoupled from emission_bias so a lone 0.9-confidence cycle is
    # still worth including (emission 0.9-1.0 = -0.1 beats the 0.2 skip)
    # while garbage cycles (<0.7) stay near-free to drop.
    skip_offset: float = 0.7
    # Bonus for a path candidate that names a verse the tracker actually
    # COMMITTED: commits survived every live gate (ambiguity, stability,
    # residual, feasibility), so the final path should prefer explaining
    # them over raw candidate noise.
    commit_anchor: float = 0.6
    # Expectation subtracted from candidate confidence in the final
    # Viterbi: fusion confidences run 0.7-1.0 even on garbage cycles,
    # so emissions are scored relative to this bias. 1.0 per the round-3
    # offline sweep over v1+v2+v3 oracle dumps (hypothesis_sweep:
    # Viterbi seq-acc 0.80/0.82/0.80 -> 0.93/0.88/0.89 vs the old 0.8).
    # Higher values score better still on the oracle (1.35 -> 0.98 v1;
    # round-4 sweep: 1.1 lifts the v1 oracle Viterbi 0.864 -> 0.909 and
    # v3 offline +1.2pp) but converge the path onto commits alone — at
    # 1.1 a commit-less flow of two 0.8-confidence cycles already
    # finalizes to NOTHING (tests/test_tracker.py
    # test_continuation_beats_jump), so 1.0 stays: real streaming runs
    # have sparse, sometimes wrong commits and the path must still
    # explain candidate-only evidence.
    emission_bias: float = 1.0
    # True = commits (expanded spans, in order) ARE the final sequence
    # whenever any exist; the candidate-cycle Viterbi runs only for
    # commit-less utterances. Measured on round-5 REAL-run dumps:
    # commit-primary 0.769/0.537 (v1/v2) vs pure Viterbi 0.615/0.268 —
    # see tracker.StreamingHypothesis.finalize. False reproduces the
    # reference-faithful unconditional Viterbi (tracker.ts:314-431).
    commit_primary: bool = True


def hypothesis_params_from_env() -> HypothesisParams:
    def env(name: str, fallback: float) -> float:
        raw = os.getenv(f"STREAMING_HYPOTHESIS_{name}")
        if raw is None:
            return fallback
        try:
            return float(raw)
        except ValueError:
            return fallback

    d = HypothesisParams()
    return HypothesisParams(
        surah_jump_high_confidence=env(
            "SURAH_JUMP_HIGH_CONFIDENCE", d.surah_jump_high_confidence
        ),
        surah_jump=env("SURAH_JUMP", d.surah_jump),
        same_ayah=env("SAME_AYAH", d.same_ayah),
        next_ayah=env("NEXT_AYAH", d.next_ayah),
        small_forward_per_ayah=env(
            "SMALL_FORWARD_PER_AYAH", d.small_forward_per_ayah
        ),
        backward=env("BACKWARD", d.backward),
        far_forward=env("FAR_FORWARD", d.far_forward),
        skip_scale=env("SKIP_SCALE", d.skip_scale),
        skip_offset=env("SKIP_OFFSET", d.skip_offset),
        commit_anchor=env("COMMIT_ANCHOR", d.commit_anchor),
        emission_bias=env("EMISSION_BIAS", d.emission_bias),
        commit_primary=bool(env("COMMIT_PRIMARY", 1.0 if d.commit_primary else 0.0)),
    )
