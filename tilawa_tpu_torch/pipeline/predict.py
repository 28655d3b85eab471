"""The champion batch pipeline: audio → (surah, ayah[, ayah_end]).

Port of tilawa_tpu/pipeline/predict.py Recognizer on the torch runtime:

  encoder forward (log-probs stay on the device, argmax ids to the host)
  → CTC collapse + detokenize + normalize → pass-1 text match → 0.80
  text-confidence gate → three-strategy candidate build → CTC rerank on
  the device (span penalty 0.5) → best.

TTA (reference: c2c-direct-mixed-tta/run.py): anchor 1.0x pass; if score
< 0.5, the 0.9x/1.1x perturbed passes run as one batched 2-way forward
(per-variant forwards for clips past LONG_THRESHOLD), then majority vote
with score-pick fallback.
"""

from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np

from tilawa_tpu_torch.data.audio import load_audio, speed_perturb
from tilawa_tpu_torch.data.normalizer import normalize_arabic
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.data.token_store import TokenStore
from tilawa_tpu_torch.ops.ctc import collapse_ctc
from tilawa_tpu_torch.pipeline.candidates import build_candidates, text_match
from tilawa_tpu_torch.pipeline.rerank import ctc_rerank
from tilawa_tpu_torch.pipeline.runtime import LONG_THRESHOLD

FALLBACK_THRESHOLD = float(os.getenv("TILAWA_THRESHOLD", "0.80"))
TTA_SKIP_THRESHOLD = float(os.getenv("TILAWA_TTA_SKIP", "0.5"))
TTA_FACTORS = (0.9, 1.1)


def _empty(transcript: str = "") -> dict:
    return {
        "surah": 0,
        "ayah": 0,
        "ayah_end": None,
        "score": 0.0,
        "transcript": transcript,
        "candidates": [],
    }


class Recognizer:
    """predict()/transcribe() over an EncoderRuntime (the JAX Recognizer's
    gated rerank mode; the "always"/"never" modes of the other experiment
    families are not ported yet)."""

    def __init__(
        self,
        runtime,
        db: QuranDB | None = None,
        token_store: TokenStore | None = None,
        tokenizer=None,
        tta: bool = False,
    ):
        self.runtime = runtime
        self.db = db or QuranDB()
        self.token_store = token_store or TokenStore.load_default()
        self.tokenizer = tokenizer or self.token_store.tokenizer
        self.tta = tta

    def decode_ids(self, ids: np.ndarray) -> str:
        deduped = collapse_ctc(np.asarray(ids), self.runtime.blank_id)
        if not deduped:
            return ""
        return normalize_arabic(self.tokenizer.decode(deduped).strip())

    def _predict_from_logprobs(self, log_probs, t_valid: int, transcript: str) -> dict:
        if not transcript.strip():
            return _empty("")

        base = text_match(self.db, transcript)
        # The champion's gate: CTC rerank only when the text match scores
        # below 0.80 (reference: c2c-direct/run.py:66).
        use_ctc = base is None or float(base.get("score", 0.0)) < FALLBACK_THRESHOLD
        # The expensive retrieval passes only run when the rerank will
        # consume them (the gate depends on the pass-1 score alone).
        candidates = (
            build_candidates(self.db, transcript, base=base)[0] if use_ctc else []
        )
        if not candidates and not base:
            return _empty(transcript)
        ranked = (
            ctc_rerank(log_probs, t_valid, candidates, self.token_store,
                       blank_id=self.runtime.blank_id)
            if use_ctc
            else []
        )

        if use_ctc and ranked:
            best = ranked[0]
            source = "ctc"
            score = (
                math.exp(-best["ctc_norm_loss"])
                if math.isfinite(best["ctc_norm_loss"])
                else 0.0
            )
        elif base:
            best, source, score = base, "text", float(base.get("score", 0.0))
        else:
            return _empty(transcript)

        out_candidates = [
            {
                "surah": c["surah"],
                "ayah": c["ayah"],
                "ayah_end": c.get("ayah_end") or c["ayah"],
                "score": round(float(c.get("final_score", c.get("score", 0.0))), 4),
            }
            for c in (ranked[:5] if ranked else [best])
        ]
        return {
            "surah": best["surah"],
            "ayah": best["ayah"],
            "ayah_end": best.get("ayah_end") or best["ayah"],
            "score": round(score, 4),
            "transcript": transcript,
            "source": source,
            "candidates": out_candidates,
        }

    def predict_audio(self, audio: np.ndarray) -> dict:
        lp, ids, t_valid = self.runtime.forward(audio)
        result = self._predict_from_logprobs(lp, t_valid, self.decode_ids(ids))
        if not self.tta or result["score"] >= TTA_SKIP_THRESHOLD:
            return result

        # Hard sample: the 0.9x/1.1x perturbed passes.
        perturbed = [speed_perturb(audio, f) for f in TTA_FACTORS]
        if max(len(p) for p in perturbed) > LONG_THRESHOLD:
            # Long clip: per-variant forwards on the [1, bucket] shape.
            preds = []
            for p in perturbed:
                lp_p, ids_p, tv_p = self.runtime.forward(p)
                preds.append(
                    self._predict_from_logprobs(lp_p, tv_p, self.decode_ids(ids_p))
                )
        else:
            lps, t_valids, ids_b = self.runtime.forward_batch(perturbed)
            preds = [
                self._predict_from_logprobs(
                    lps[i], int(t_valids[i]),
                    self.decode_ids(ids_b[i, : int(t_valids[i])]),
                )
                for i in range(len(perturbed))
            ]
        return self.tta_vote([preds[0], result, preds[1]])  # 0.9x, 1.0x, 1.1x

    @staticmethod
    def tta_vote(all_preds: list[dict]) -> dict:
        """Majority vote over [0.9x, 1.0x, 1.1x] predictions, highest-score
        fallback (reference: c2c-direct-mixed-tta/run.py:133-148)."""
        keys = [(p["surah"], p["ayah"]) for p in all_preds]
        counts: dict[tuple[int, int], int] = {}
        for k in keys:
            counts[k] = counts.get(k, 0) + 1
        top = max(counts, key=counts.get)
        if counts[top] >= 2:
            for p in all_preds:
                if (p["surah"], p["ayah"]) == top:
                    p["tta"] = "majority"
                    p["tta_preds"] = keys
                    return p
        best = max(all_preds, key=lambda p: p["score"])
        best["tta"] = "score_pick"
        best["tta_preds"] = keys
        best["tta_scores"] = [p["score"] for p in all_preds]
        return best

    def predict(self, audio_path: str | Path) -> dict:
        return self.predict_audio(load_audio(audio_path))

    # ---------------------------------------------------------- transcribe

    LONG_CHUNK_S = 25.0
    LONG_OVERLAP_S = 1.0

    def transcribe_audio(self, audio: np.ndarray) -> str:
        if len(audio) > self.LONG_CHUNK_S * 16000:
            # A very long clip would take an unbounded bucket with quadratic
            # attention: 25 s windows decoded and concatenated instead.
            return self._transcribe_long(audio)
        _lp, ids, _t = self.runtime.forward(audio)
        return self.decode_ids(ids)

    def _transcribe_long(self, audio: np.ndarray) -> str:
        """25 s windows with 1 s overlap, decoded independently in one
        batched forward and concatenated (reference: w2v-phonemes long-file
        chunking, EXPERIMENTS.md:245)."""
        sr = 16000
        step = int((self.LONG_CHUNK_S - self.LONG_OVERLAP_S) * sr)
        chunk = int(self.LONG_CHUNK_S * sr)
        pieces = [audio[s:s + chunk] for s in range(0, max(len(audio) - 1, 1), step)]
        pieces = [p for p in pieces if len(p) >= sr // 2] or [audio[:chunk]]
        _lps, t_valids, ids_b = self.runtime.forward_batch(pieces)
        texts = [
            self.decode_ids(ids_b[i, : int(t_valids[i])])
            for i in range(len(pieces))
        ]
        return " ".join(t for t in texts if t).strip()

    def transcribe(self, audio_path: str | Path) -> str:
        return self.transcribe_audio(load_audio(audio_path))
