"""The champion batch pipeline: audio → (surah, ayah[, ayah_end]).

Port of tilawa_tpu/pipeline/predict.py Recognizer on the torch runtime:

  encoder forward (log-probs stay on the device, argmax ids to the host)
  → CTC collapse + detokenize + normalize → pass-1 text match → 0.80
  text-confidence gate → three-strategy candidate build → CTC rerank on
  the device (span penalty 0.5) → best.

rerank_mode "always" (ctc-alignment) reranks every clip and "never"
(fastconformer-zeroshot) none. A runtime without forward (an oracle)
hands over host log-probs: the greedy decode reads them on the host and
the rerank scores them on the recognizer's device.

TTA (reference: c2c-direct-mixed-tta/run.py): anchor 1.0x pass; if score
< 0.5, the 0.9x/1.1x perturbed passes run as one batched 2-way forward
(per-variant forwards for clips past LONG_THRESHOLD), then majority vote
with score-pick fallback.

transcribe_result is the streaming tracker's acoustic decode: text, the
collapsed ids and the log-probs, which stay on the device for the
tracker's CTC fusion scoring.

With TILAWA_PROFILE set (read at construction) predict_audio leaves its
stage wall times in last_profile: forward (with the id fetch and
decode), decode, build (retrieval), rerank, tta and audio_s.
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from tilawa_tpu_torch.data.audio import load_audio, speed_perturb
from tilawa_tpu_torch.data.normalizer import normalize_arabic
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.data.token_store import TokenStore
from tilawa_tpu_torch.device import resolve_device, upload
from tilawa_tpu_torch.models.convert import packed_size_bytes
from tilawa_tpu_torch.ops.ctc import collapse_ctc, pad_frames
from tilawa_tpu_torch.pipeline.candidates import build_candidates, text_match
from tilawa_tpu_torch.pipeline.rerank import ctc_rerank
from tilawa_tpu_torch.pipeline.runtime import LONG_THRESHOLD, StreamingEncoderCache
from tilawa_tpu_torch.streaming.tracker import TranscribeResult

FALLBACK_THRESHOLD = float(os.getenv("TILAWA_THRESHOLD", "0.80"))
TTA_SKIP_THRESHOLD = float(os.getenv("TILAWA_TTA_SKIP", "0.5"))
TTA_FACTORS = (0.9, 1.1)
# Window-level streaming TTA (one [2, bucket] forward a decode cycle), read
# at import as the JAX package reads it.
STREAM_TTA = os.getenv("TILAWA_STREAM_TTA", "") not in ("", "0", "false")


def keeps_variant(n_window: int, n_variant: int) -> bool:
    """The window TTA's pick between the collapsed decodes of the window and
    of its 0.9x variant: the variant only where it has more than one token
    more (a tie keeps the window)."""
    return n_variant > n_window + 1


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
    """predict()/transcribe() over an acoustic runtime: an EncoderRuntime
    (forward, forward_batch: log-probs on the device) or any runtime
    exposing log_probs(audio) -> ([T, V], t_valid) and log_probs_batch."""

    def __init__(
        self,
        runtime,
        db: QuranDB | None = None,
        token_store: TokenStore | None = None,
        tokenizer=None,
        tta: bool = False,
        rerank_mode: str = "gated",
        device: str | torch.device | None = None,
    ):
        """rerank_mode: "gated" (the champion: CTC rerank only when the
        text match scores < 0.80, reference c2c-direct/run.py:66), "always"
        (ctc-alignment-style forced alignment of every candidate) or
        "never" (nvidia-fastconformer-style zero-shot text matching).
        device: where host log-probs are scored; the runtime's device by
        default, else the card."""
        if rerank_mode not in ("gated", "always", "never"):
            raise ValueError(f"unknown rerank_mode {rerank_mode!r}")
        self.runtime = runtime
        self.db = db or QuranDB()
        self.token_store = token_store or TokenStore.load_default()
        self.tokenizer = tokenizer or self.token_store.tokenizer
        self.tta = tta
        self.rerank_mode = rerank_mode
        if device is None and hasattr(runtime, "device"):
            self.device = runtime.device
        else:
            self.device = resolve_device(device)
        self.profile = os.getenv("TILAWA_PROFILE", "") not in ("", "0", "false")
        self.last_profile: dict[str, float] = {}
        self._stream_cache: StreamingEncoderCache | None = None

    # ------------------------------------------------------------ decoding

    def greedy_decode(self, log_probs, t_valid: int) -> str:
        """Greedy CTC text of host (numpy) or device log-probs."""
        if isinstance(log_probs, torch.Tensor):
            ids = log_probs[:t_valid].argmax(dim=-1).cpu().numpy()
        else:
            ids = np.asarray(log_probs[:t_valid]).argmax(axis=-1)
        return self.decode_ids(ids)

    def decode_ids(self, ids: np.ndarray) -> str:
        deduped = collapse_ctc(np.asarray(ids), self.runtime.blank_id)
        if not deduped:
            return ""
        return normalize_arabic(self.tokenizer.decode(deduped).strip())

    # ------------------------------------------------------------- predict

    def _on_device(self, log_probs, t_valid: int):
        """Log-probs for the rerank: a device tensor as it is; host
        log-probs padded to a frame bucket and uploaded to self.device."""
        if isinstance(log_probs, torch.Tensor):
            return log_probs
        padded, _t = pad_frames(np.asarray(log_probs[:t_valid], dtype=np.float32))
        return upload(padded, self.device)

    def _predict_from_logprobs(
        self, log_probs, t_valid: int, transcript: str | None = None
    ) -> dict:
        t0 = time.perf_counter()
        if transcript is None:
            transcript = self.greedy_decode(log_probs, t_valid)
        t1 = time.perf_counter()
        if not transcript.strip():
            return _empty("")

        base = text_match(self.db, transcript)
        if self.rerank_mode == "always":
            use_ctc = True
        elif self.rerank_mode == "never":
            use_ctc = False
        else:
            use_ctc = base is None or float(base.get("score", 0.0)) < FALLBACK_THRESHOLD
        # The expensive retrieval passes only run when the rerank will
        # consume them (the gate depends on the pass-1 score alone).
        candidates = (
            build_candidates(self.db, transcript, base=base)[0] if use_ctc else []
        )
        t2 = time.perf_counter()
        if not candidates and not base:
            return _empty(transcript)
        ranked = (
            ctc_rerank(self._on_device(log_probs, t_valid), t_valid, candidates,
                       self.token_store, blank_id=self.runtime.blank_id)
            if use_ctc
            else []
        )
        t3 = time.perf_counter()
        if self.profile:
            self.last_profile.update(decode=t1 - t0, build=t2 - t1, rerank=t3 - t2)

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
        t0 = time.perf_counter()
        device_path = hasattr(self.runtime, "forward")
        if device_path:
            # Only the argmax ids cross to the host; the log-probs stay on
            # the device for the rerank.
            lp, ids, t_valid = self.runtime.forward(audio)
            transcript = self.decode_ids(ids)
        else:
            lp, t_valid = self.runtime.log_probs(audio)
            transcript = None
        if self.profile:
            self.last_profile = {"forward": time.perf_counter() - t0}
        result = self._predict_from_logprobs(lp, t_valid, transcript)
        if not self.tta or result["score"] >= TTA_SKIP_THRESHOLD:
            if self.profile:
                self.last_profile["audio_s"] = len(audio) / 16000.0
            return result

        t_tta = time.perf_counter()
        # Hard sample: the 0.9x/1.1x perturbed passes.
        perturbed = [speed_perturb(audio, f) for f in TTA_FACTORS]
        if device_path and max(len(p) for p in perturbed) > LONG_THRESHOLD:
            # Long clip: per-variant forwards on the [1, bucket] shape.
            preds = []
            for p in perturbed:
                lp_p, ids_p, tv_p = self.runtime.forward(p)
                preds.append(
                    self._predict_from_logprobs(lp_p, tv_p, self.decode_ids(ids_p))
                )
        elif device_path:
            lps, t_valids, ids_b = self.runtime.forward_batch(perturbed)
            preds = [
                self._predict_from_logprobs(
                    lps[i], int(t_valids[i]),
                    self.decode_ids(ids_b[i, : int(t_valids[i])]),
                )
                for i in range(len(perturbed))
            ]
        else:
            lps, t_valids = self.runtime.log_probs_batch(perturbed)
            preds = [
                self._predict_from_logprobs(lps[i], int(t_valids[i]))
                for i in range(len(perturbed))
            ]
        if self.profile:
            self.last_profile["tta"] = time.perf_counter() - t_tta
            self.last_profile["audio_s"] = len(audio) / 16000.0
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

    def model_size(self) -> int:
        """Bytes of the runtime's weights as the bundle stores them."""
        variables = getattr(self.runtime, "variables", None)
        return packed_size_bytes(variables) if variables is not None else 0

    # ---------------------------------------------------------- transcribe

    LONG_CHUNK_S = 25.0
    LONG_OVERLAP_S = 1.0

    def transcribe_audio(self, audio: np.ndarray) -> str:
        if not self.runtime.long_chunking and len(audio) > self.LONG_CHUNK_S * 16000:
            # Without chunking a very long clip would take an unbounded
            # bucket with quadratic attention: 25 s windows decoded and
            # concatenated instead.
            return self._transcribe_long(audio)
        # forward() chunk-stitches long clips when chunking is on.
        _lp, ids, _t = self.runtime.forward(audio)
        return self.decode_ids(ids)

    def transcribe_result(self, audio: np.ndarray) -> TranscribeResult:
        """Full acoustic decode of one streaming window: normalized text,
        collapsed token ids and the log-probs, left on the device for the
        tracker's CTC fusion scoring.

        With long_chunking the window goes through a StreamingEncoderCache
        (past 16 s only the windows not seen before are forwarded), whatever
        STREAM_TTA says. Otherwise, with STREAM_TTA (TILAWA_STREAM_TTA) and
        at least 1 s of audio, the window and its 0.9x speed variant run as
        one [2, bucket] forward_batch (the bucket of the longer row) and the
        variant is kept only when its collapsed decode has more than one
        token more than the window's; its log-probs stay on the device as
        the full bucket row (tilawa_tpu/pipeline/predict.py:315-331; off by
        default, and EXPERIMENTS.md measured it as a v1 streaming
        regression). Otherwise one plain forward."""
        rt = self.runtime
        if rt.long_chunking:
            if self._stream_cache is None:
                self._stream_cache = StreamingEncoderCache(rt)
            lp, ids, t_valid = self._stream_cache.forward(audio)
        elif STREAM_TTA and len(audio) >= 16000:
            lps, lens, ids_b = rt.forward_batch([audio, speed_perturb(audio, 0.9)])
            t0, t1 = int(lens[0]), int(lens[1])
            d0 = collapse_ctc(ids_b[0, :t0], rt.blank_id)
            d1 = collapse_ctc(ids_b[1, :t1], rt.blank_id)
            if keeps_variant(len(d0), len(d1)):
                lp, ids, t_valid = lps[1], ids_b[1, :t1], t1
            else:
                lp, ids, t_valid = lps[0], ids_b[0, :t0], t0
        else:
            lp, ids, t_valid = rt.forward(audio)
        deduped = collapse_ctc(ids, rt.blank_id)
        text = normalize_arabic(self.tokenizer.decode(deduped).strip()) if deduped else ""
        return TranscribeResult(
            text=text, token_ids=list(deduped), log_probs=lp, t_valid=int(t_valid),
        )

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
