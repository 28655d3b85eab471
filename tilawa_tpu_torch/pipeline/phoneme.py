"""Phoneme pipeline: audio → phoneme string → mispronunciation report.

The reference's phoneme experiment pairs a 69-token phoneme-CTC
FastConformer with per-verse reference phonemes to flag mispronunciations
(reference: experiments/fastconformer-phoneme/run.py:265-358). Port of
tilawa_tpu/pipeline/phoneme.py: the acoustic side is any runtime exposing
`log_probs(audio)` over the phoneme vocabulary — the port's EncoderRuntime
on a phoneme bundle (FastConformerConfig.phoneme(), exports/phoneme-int8)
or the synthetic oracle below, which renders on the host with numpy from
an explicit seed exactly as the JAX package's does — and the analysis side
is PhonemeStore + the alignment/correction ops.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tilawa_tpu_torch.data.audio import load_audio
from tilawa_tpu_torch.data.phonemes import PhonemeStore


class PhonemePipeline:
    def __init__(self, runtime, store: PhonemeStore | None = None):
        self.runtime = runtime
        self.store = store or PhonemeStore.load_default()

    # -------------------------------------------------------------- decode

    def transcribe_phonemes_audio(self, audio: np.ndarray) -> str:
        lp, t_valid = self.runtime.log_probs(audio)
        return self.store.decode_logprobs(lp, t_valid)

    def transcribe_phonemes(self, audio_path: str | Path) -> str:
        return self.transcribe_phonemes_audio(load_audio(audio_path))

    # --------------------------------------------------- mispronunciations

    def detect_mispronunciations_audio(
        self,
        audio: np.ndarray,
        surah: int,
        ayah: int,
        ayah_end: int | None = None,
        max_word_index: int | None = None,
    ) -> dict:
        predicted = self.transcribe_phonemes_audio(audio)
        return self.store.detect_mispronunciations(
            predicted, surah, ayah, ayah_end, max_word_index
        )

    def detect_mispronunciations(
        self,
        audio_path: str | Path,
        surah: int,
        ayah: int,
        ayah_end: int | None = None,
        max_word_index: int | None = None,
    ) -> dict:
        return self.detect_mispronunciations_audio(
            load_audio(audio_path), surah, ayah, ayah_end, max_word_index
        )


class PhonemeOracleRuntime:
    """Synthetic phoneme acoustics: (surah, ayah) → phoneme CTC log-probs.

    The phoneme analogue of OracleRuntime: renders frame-paced log-probs
    from the reference phoneme string, optionally corrupting a fraction of
    tokens so alignment/correction paths see realistic errors.
    """

    def __init__(
        self,
        store: PhonemeStore | None = None,
        frames_per_token: int = 2,
        noise: float = 0.1,
        error_rate: float = 0.0,
        seed: int = 0,
    ):
        self.store = store or PhonemeStore.load_default()
        self.blank_id = self.store.blank_id
        self.frames_per_token = frames_per_token
        self.noise = noise
        self.error_rate = error_rate
        self._rng = np.random.default_rng(seed)

    def render(self, surah: int, ayah: int, ayah_end: int | None = None):
        ref = self.store.reference_phonemes(surah, ayah, ayah_end)
        tok_to_id = {t: i for i, t in enumerate(self.store.vocab)}
        ids = [tok_to_id[t] for t in ref.split() if t in tok_to_id]
        if self.error_rate > 0:
            ids = [
                int(self._rng.integers(0, self.blank_id))
                if self._rng.random() < self.error_rate else i
                for i in ids
            ]
        v = self.store.num_classes
        t = max(len(ids) * self.frames_per_token + 4, 8)
        lp = np.full((t, v), -20.0, dtype=np.float32)
        frame = 0
        for tok in ids:
            for _ in range(self.frames_per_token - 1):
                lp[frame, self.blank_id] = 0.0
                frame += 1
            lp[frame, tok] = 0.0
            frame += 1
        while frame < t:
            lp[frame, self.blank_id] = 0.0
            frame += 1
        if self.noise > 0:
            lp = lp + self._rng.normal(0, self.noise, lp.shape).astype(np.float32)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        return lp.astype(np.float32), t
