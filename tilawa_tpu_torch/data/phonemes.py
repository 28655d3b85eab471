"""Phoneme vocabulary + per-verse reference phonemes (a copy of
tilawa_tpu/data/phonemes.py; host code, no framework).

The reference's phoneme pipeline uses a 69-token Buckwalter-style phoneme
vocabulary with CTC blank at index 69 (reference:
experiments/fastconformer-phoneme/run.py:43-55) and precomputed per-verse
phoneme strings in data/quran_phonemes.json (built by
scripts/precompute_quran_phonemes.py). This module is the framework-side
store for both, plus CTC phoneme decode and mispronunciation detection
(reference: fastconformer-phoneme/run.py:322-358).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import numpy as np

from tilawa_tpu_torch.data.assets import default_asset_path
from tilawa_tpu_torch.text.phonemes import align_phoneme_strings, word_corrections


class PhonemeStore:
    """69-token phoneme vocab (+ blank) and 6,236 per-verse references."""

    def __init__(
        self,
        vocab_path: str | Path | None = None,
        refs_path: str | Path | None = None,
    ):
        vp = Path(vocab_path) if vocab_path else default_asset_path("phoneme_vocab.json")
        with open(vp, encoding="utf-8") as f:
            raw = json.load(f)
        size = max(int(k) for k in raw) + 1
        self.vocab: list[str] = [""] * size
        for k, v in raw.items():
            self.vocab[int(k)] = v
        # Blank is the last index when the dump includes it, else appended
        # (run.py:55: BLANK_ID = len(PHONEME_VOCAB)).
        self.blank_id = size - 1 if self.vocab[-1] in ("", "<blank>", "<b>") else size
        self.num_classes = self.blank_id + 1

        rp = Path(refs_path) if refs_path else default_asset_path("quran_phonemes.json")
        with open(rp, encoding="utf-8") as f:
            rows = json.load(f)
        self.refs: dict[tuple[int, int], str] = {
            (int(r["surah"]), int(r["ayah"])): r["phonemes"] for r in rows
        }

    @classmethod
    @lru_cache(maxsize=1)
    def load_default(cls) -> "PhonemeStore":
        return cls()

    # ------------------------------------------------------------- lookups

    def encode_phonemes(self, phonemes: str) -> list[int]:
        """Space-separated phoneme string → vocab ids (unknown tokens are
        dropped). Inverse of decode_ids; used to build CTC training targets
        for the phoneme head (reference trains on exactly these strings:
        scripts/train_fastconformer_phoneme_modal.py _PhonemeTokenizer)."""
        if not hasattr(self, "_inv"):
            self._inv = {tok: i for i, tok in enumerate(self.vocab) if tok}
        return [
            self._inv[tok] for tok in phonemes.split() if tok in self._inv
        ]

    def verse_ids(self, surah: int, ayah: int, ayah_end: int | None = None) -> list[int]:
        return self.encode_phonemes(self.reference_phonemes(surah, ayah, ayah_end))

    def match_verse(self, predicted_phonemes: str, top_k: int = 5) -> list[dict]:
        """Fuzzy verse retrieval in phoneme space: batched edit-ratio scan
        of the predicted string against all 6,236 verse phoneme strings
        (reference: experiments/w2v-phonemes/run.py Levenshtein over
        quran_phonemes.json). Returns [{surah, ayah, score}] best-first."""
        from tilawa_tpu_torch.text.levenshtein import Corpus

        if not predicted_phonemes.strip():
            return []
        if not hasattr(self, "_corpus"):
            self._keys = sorted(self.refs)
            self._corpus = Corpus([self.refs[k] for k in self._keys])
        scores = self._corpus.batch_ratio(predicted_phonemes)
        order = np.argsort(-scores, kind="stable")[:top_k]
        return [
            {
                "surah": self._keys[i][0],
                "ayah": self._keys[i][1],
                "score": float(scores[i]),
            }
            for i in order
        ]

    def ngram_vote(
        self, predicted_phonemes: str, n: int = 5, top_surahs: int = 5
    ) -> list[dict]:
        """Rarity-weighted phoneme n-gram surah voting (reference:
        experiments/w2v-phonemes/run.py:234-293 — the retrieval idea, not
        the model). Every n-gram of the predicted stream votes 1/df for
        each (surah, ayah) that contains it; votes aggregate per surah and
        the best CONTIGUOUS ayah run per top surah wins. Rare n-grams
        localize a recitation even when the edit-ratio scan buries the
        true verse under length mismatch — this widens the candidate pool
        for the peel-off and span passes.

        Returns [{surah, ayah, ayah_end, weight}] best-first."""
        toks = [t for t in predicted_phonemes.split() if t != "|"]
        if len(toks) < n:
            return []
        if not hasattr(self, "_ngram_index") or self._ngram_n != n:
            positions: dict[tuple, list[tuple[int, int]]] = {}
            counts: dict[tuple, int] = {}
            for key, ref in self.refs.items():
                rtoks = [t for t in ref.split() if t != "|"]
                seen_here = set()
                for i in range(len(rtoks) - n + 1):
                    ng = tuple(rtoks[i:i + n])
                    counts[ng] = counts.get(ng, 0) + 1
                    if ng not in seen_here:
                        positions.setdefault(ng, []).append(key)
                        seen_here.add(ng)
            self._ngram_index = (positions, counts)
            self._ngram_n = n
        positions, counts = self._ngram_index
        votes: dict[tuple[int, int], float] = {}
        for i in range(len(toks) - n + 1):
            ng = tuple(toks[i:i + n])
            hit = positions.get(ng)
            if not hit:
                continue
            w = 1.0 / counts[ng]
            for key in hit:
                votes[key] = votes.get(key, 0.0) + w
        if not votes:
            return []
        by_surah: dict[int, dict[int, float]] = {}
        for (s, a), w in votes.items():
            by_surah.setdefault(s, {})[a] = w
        ranked = sorted(
            by_surah.items(), key=lambda kv: sum(kv[1].values()), reverse=True
        )
        results: list[dict] = []
        for surah, ayah_w in ranked[: top_surahs * 2]:
            ayahs = sorted(ayah_w)
            runs: list[tuple[int, int, float]] = []
            rs = re = ayahs[0]
            rw = ayah_w[rs]
            for a in ayahs[1:]:
                if a == re + 1:
                    re, rw = a, rw + ayah_w[a]
                else:
                    runs.append((rs, re, rw))
                    rs, re, rw = a, a, ayah_w[a]
            runs.append((rs, re, rw))
            best = max(runs, key=lambda r: r[2])
            results.append(
                {"surah": surah, "ayah": best[0], "ayah_end": best[1],
                 "weight": best[2]}
            )
        results.sort(key=lambda r: r["weight"], reverse=True)
        return results[:top_surahs]

    def reference_phonemes(self, surah: int, ayah: int, ayah_end: int | None = None) -> str:
        """Per-verse reference string; spans join verse strings with `|`."""
        if ayah_end is None or ayah_end <= ayah:
            return self.refs.get((surah, ayah), "")
        parts = [self.refs.get((surah, a), "") for a in range(ayah, ayah_end + 1)]
        return " | ".join(p for p in parts if p)

    # -------------------------------------------------------------- decode

    def decode_ids(self, ids: list[int] | np.ndarray) -> str:
        """CTC-collapsed ids → space-joined phoneme string (run.py:293-314)."""
        out: list[str] = []
        prev = -1
        for idx in np.asarray(ids, dtype=np.int64):
            idx = int(idx)
            if idx != prev and idx != self.blank_id and 0 <= idx < len(self.vocab):
                out.append(self.vocab[idx])
            prev = idx
        return " ".join(out)

    def decode_logprobs(self, log_probs: np.ndarray, t_valid: int | None = None) -> str:
        lp = np.asarray(log_probs)
        if t_valid is not None:
            lp = lp[:t_valid]
        return self.decode_ids(lp.argmax(axis=-1))

    # --------------------------------------------------- mispronunciations

    def detect_mispronunciations(
        self,
        predicted_phonemes: str,
        surah: int,
        ayah: int,
        ayah_end: int | None = None,
        max_word_index: int | None = None,
    ) -> dict:
        """Compare a predicted phoneme string against the verse reference.

        Returns predicted/reference strings, per-position errors, PER, and
        word-level corrections (reference: fastconformer-phoneme/run.py:322-358
        + lib/correction.ts:20-91 combined in one report).
        """
        reference = self.reference_phonemes(surah, ayah, ayah_end)
        if not reference:
            return {
                "predicted_phonemes": predicted_phonemes,
                "reference_phonemes": "",
                "errors": [],
                "per": 0.0,
                "corrections": [],
                "error": f"No reference phonemes for surah {surah}, ayah {ayah}",
            }
        alignment = align_phoneme_strings(
            predicted_phonemes.replace(" | ", " "), reference.replace(" | ", " ")
        )
        return {
            "predicted_phonemes": predicted_phonemes,
            "reference_phonemes": reference,
            "errors": [e.to_dict() for e in alignment.errors],
            "per": alignment.per,
            "correct_rate": alignment.correct_rate,
            "corrections": word_corrections(
                predicted_phonemes, reference, max_word_index
            ),
        }
