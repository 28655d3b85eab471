"""StreamingPipeline — chunked-audio / full-transcript verse detection.

Behavioral parity with the reference pipeline (reference:
shared/streaming.py): three eval modes (text snapshots, full-transcript
peel-off loop with hint threading and 0.3→0.7 threshold tightening, chunked
audio with confidence gating avg_logprob < -1.0 / < 2 words plus the
tentative/confirm buffer with MAX_HOLD_CHUNKS retraction).

Chunked mode feeds numpy slices straight to the backend — no temp-file WAV
round-trip (the reference writes each chunk to disk for its transcribe_fn;
our backends accept arrays, with a path-based fallback preserved for
external callables).
"""

from __future__ import annotations

import numpy as np

from tilawa_tpu_torch.data.audio import load_audio, save_wav
from tilawa_tpu_torch.data.normalizer import normalize_arabic
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.streaming.verse_tracker import (
    STREAMING_MIN_EMIT_SCORE,
    VerseTracker,
)

SAMPLE_RATE = 16000
MIN_CHUNK_SAMPLES = 8000          # 0.5 s
MIN_CHUNK_LOG_PROB = -1.0
MIN_CHUNK_WORDS = 2
HIGH_CONFIDENCE_THRESHOLD = 0.7
MAX_HOLD_CHUNKS = 3


class StreamingPipeline:
    def __init__(self, db: QuranDB | None = None):
        self.db = db or QuranDB()

    def run_on_text(self, text_chunks: list[str]) -> list[dict]:
        """Accumulated-transcript snapshots → ordered emissions."""
        tracker = VerseTracker(self.db)
        out: list[dict] = []
        for text in text_chunks:
            out.extend(tracker.process_text(text))
        out.extend(tracker.finalize())
        return out

    def run_on_full_transcript(self, audio_path: str, transcribe_fn) -> list[dict]:
        """Whole-file transcript → iterative match→trim→hint peel-off."""
        transcript = transcribe_fn(audio_path)
        remaining = normalize_arabic(transcript)
        if not remaining.strip():
            return []
        emissions: list[dict] = []
        hint = None
        min_score = 0.3
        for _ in range(20):
            if not remaining.strip():
                break
            result = self.db.match_verse(remaining, max_span=8, hint=hint, seeded_spans=True)
            if not result or result.get("score", 0) < min_score:
                break
            min_score = 0.7
            surah = result["surah"]
            start = result["ayah"]
            end = result.get("ayah_end") or start
            for ayah in range(start, end + 1):
                emissions.append(
                    {"surah": surah, "ayah": ayah, "score": result["score"]}
                )
            matched_words = result["text_clean"].split()
            rem_words = remaining.split()
            remaining = " ".join(rem_words[min(len(matched_words), len(rem_words)):])
            hint = (surah, end)
        return emissions

    def run_on_audio_chunked(
        self,
        audio_path: str,
        transcribe_fn,
        chunk_seconds: float = 3.0,
        overlap_seconds: float = 0.0,
    ) -> list[dict]:
        """Chunked audio → confidence-gated tracker feed with the
        tentative/confirm emission buffer."""
        audio = load_audio(audio_path)
        chunk_size = int(chunk_seconds * SAMPLE_RATE)
        step = max(chunk_size - int(overlap_seconds * SAMPLE_RATE), 1)

        tracker = VerseTracker(self.db, streaming_mode=True)
        confirmed: list[dict] = []
        tentative: dict | None = None
        tentative_age = 0

        accepts_arrays = getattr(transcribe_fn, "accepts_arrays", False) or hasattr(
            transcribe_fn, "transcribe_audio"
        )

        pos = 0
        while pos < len(audio):
            chunk = audio[pos : min(pos + chunk_size, len(audio))]
            if len(chunk) < MIN_CHUNK_SAMPLES:
                break
            if len(chunk) < SAMPLE_RATE:
                chunk = np.pad(chunk, (0, SAMPLE_RATE - len(chunk)))

            try:
                raw = self._transcribe_chunk(transcribe_fn, chunk, accepts_arrays)
            except Exception:  # noqa: BLE001
                raw = ""

            if isinstance(raw, dict):
                chunk_text = raw.get("text", "").strip()
                avg_logprob = raw.get("avg_logprob", 0.0)
                gated = (
                    avg_logprob < MIN_CHUNK_LOG_PROB
                    or len(chunk_text.split()) < MIN_CHUNK_WORDS
                )
            else:
                chunk_text = str(raw).strip() if raw else ""
                gated = False

            if gated or not chunk_text:
                if tentative is not None:
                    tentative_age += 1
                    if tentative_age >= MAX_HOLD_CHUNKS:
                        tentative = None
                        tentative_age = 0
                pos += step
                continue

            emissions = tracker.process_delta(chunk_text)

            if tentative is not None:
                confirmed.append(tentative)
                tentative = None
                tentative_age = 0

            for e in emissions:
                if e["score"] >= HIGH_CONFIDENCE_THRESHOLD:
                    confirmed.append(e)
                else:
                    if tentative is not None:
                        confirmed.append(tentative)
                    tentative = e
                    tentative_age = 0

            pos += step

        if tentative is not None and tentative["score"] >= STREAMING_MIN_EMIT_SCORE:
            confirmed.append(tentative)
        confirmed.extend(tracker.finalize())
        return confirmed

    @staticmethod
    def _transcribe_chunk(transcribe_fn, chunk: np.ndarray, accepts_arrays: bool):
        if hasattr(transcribe_fn, "transcribe_audio"):
            return transcribe_fn.transcribe_audio(chunk)
        if accepts_arrays:
            return transcribe_fn(chunk)
        import os
        import tempfile

        tmp = tempfile.NamedTemporaryFile(suffix=".wav", delete=False)
        try:
            tmp.close()
            save_wav(tmp.name, chunk)
            return transcribe_fn(tmp.name)
        finally:
            os.unlink(tmp.name)
