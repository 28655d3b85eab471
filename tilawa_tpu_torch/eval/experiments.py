"""Experiment registry and runtime loading for the port.

Port of tilawa_tpu/eval/experiments.py. Experiments are lazy factories of
pipeline objects with predict()/transcribe(), built on a device (the card
unless the caller passes device="cpu") and cached per (name, device):

  c2c-direct              the shipped checkpoint as it is, gated rerank
  c2c-direct-tta          + confidence-gated 0.9x/1.1x TTA
  c2c-direct-mixed        repacked to int4 where the bundle is not int4
  c2c-direct-mixed-tta    the champion: int4, gated rerank, TTA
  fastconformer-zeroshot  greedy decode + text match, never a CTC rerank
  ctc-alignment           CTC rerank of every candidate
  fastconformer-quran-lm-fusion
                          the champion's candidates rescored by a word
                          5-gram LM (text/ngram.py; alpha 0.7, beta 1.0)
  pruned-ctc              the shipped checkpoint pruned to 12/8/6 blocks
                          (first_n or evenly_spaced; list_models/set_model)
  two-stage               a 12-block prune transcribes, the full model
                          CTC-reranks every clip's candidates
  heldout                 the champion pipeline on exports/heldout-int4
                          (or TILAWA_HELDOUT_CKPT), with TTA
  fastconformer-phoneme   the phoneme bundle (exports/phoneme-int8 or
                          TILAWA_PHONEME_CKPT): phoneme decode, phoneme-space
                          retrieval and peel-off, optional CTC rerank
                          (TILAWA_PHONEME_RERANK); without a bundle, oracle
                          acoustics labelled acoustics="oracle"
  oracle / oracle-hard    the decision stack over log-probs rendered from
                          the manifest's ground truth (no audio decoded)

load_runtime(path) puts any bundle (exports/stream6-int8 for streaming)
on an EncoderRuntime; load_champion() is the shipped checkpoint,
exports/champion-int4 unless TILAWA_CHECKPOINT names another. Where the
JAX package builds a random-init model for want of a checkpoint (the
runtime loaders, pruned-ctc, two-stage), the port raises
FileNotFoundError; where it falls back to labelled oracle acoustics
(LM fusion, the phoneme family), so does the port.
"""

from __future__ import annotations

import functools
import json
import os
from pathlib import Path

import numpy as np
import torch

from tilawa_tpu_torch.device import resolve_device
from tilawa_tpu_torch.io.bundle import (
    CHECKPOINT_DIR,
    EXPORTS_DIR,
    load_variables,
    shipped_checkpoint,
)
from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime

_REGISTRY: dict[str, callable] = {}
_CACHE: dict[tuple[str, str], object] = {}


def _env_long_chunking() -> bool:
    return os.getenv("TILAWA_LONG_CHUNKING", "") not in ("", "0", "false")


def load_runtime(
    path: str | Path | None = None,
    device: str | torch.device = "cuda",
    long_chunking: bool | None = None,
) -> EncoderRuntime:
    """The bundle at `path` (default: the shipped checkpoint) on `device`.
    long_chunking defaults to TILAWA_LONG_CHUNKING, as in the JAX package."""
    ckpt = Path(path) if path is not None else shipped_checkpoint()
    if ckpt is None:
        raise FileNotFoundError("no export bundle found (set TILAWA_CHECKPOINT)")
    if long_chunking is None:
        long_chunking = _env_long_chunking()
    config, variables = load_variables(ckpt)
    return EncoderRuntime(config, variables, device=device, long_chunking=long_chunking)


def load_champion(device: str | torch.device = "cuda") -> EncoderRuntime:
    return load_runtime(device=device, long_chunking=False)


def load_shipped(quant: str | None = None):
    """(config, variables, label) of the shipped checkpoint; quant="int4"
    packs an fp bundle's Dense kernels at load (train/quantize.py), as the
    reference's "mixed" 88 MB export does (c2c-direct-mixed/run.py:37-52)."""
    ckpt = shipped_checkpoint()
    if ckpt is None:
        raise FileNotFoundError("no export bundle found (set TILAWA_CHECKPOINT)")
    config, variables = load_variables(ckpt)
    label = str(ckpt)
    if quant and config.quant != quant:
        from tilawa_tpu_torch.train.quantize import quantize_variables, quantized_config

        variables = quantize_variables(variables)
        config = quantized_config(config)
        label += f" ({quant}-packed at load)"
    return config, variables, label


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def list_experiments() -> list[str]:
    return sorted(_REGISTRY)


def get_experiment(name: str, device: str | torch.device = "cuda"):
    """The experiment `name` on `device`, built once per (name, device)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown experiment {name!r}; have {list_experiments()}")
    key = (name, str(torch.device(device)))
    if key not in _CACHE:
        _CACHE[key] = _REGISTRY[name](device)
    return _CACHE[key]


def _load_runtime(quant: str | None = None, device: str | torch.device = "cuda"):
    """The shipped checkpoint on an EncoderRuntime on `device`, packed to
    int4 at load when quant="int4" and the bundle is not int4.

    One deliberate difference from the JAX package: with no checkpoint it
    raises instead of building a random-init model (a silent random model
    would hide a missing bundle on the card)."""
    device = resolve_device(device)
    config, variables, _label = load_shipped(quant)
    return EncoderRuntime(config, variables, device=device, long_chunking=_env_long_chunking())


def _make_recognizer(
    tta: bool, quant: str | None = "int4", rerank_mode: str = "gated",
    device: str | torch.device = "cuda",
):
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    return Recognizer(_load_runtime(quant, device), tta=tta, rerank_mode=rerank_mode)


@register("c2c-direct")
def _c2c_direct(device):
    """Full-precision reference algorithm (reference: c2c-direct/run.py):
    the checkpoint's own quantization."""
    return _make_recognizer(tta=False, quant=None, device=device)


@register("c2c-direct-tta")
def _c2c_direct_tta(device):
    """TTA on the checkpoint's native quantization (an int8 bundle stays
    int8: the int4 repack needs fp kernels)."""
    return _make_recognizer(tta=True, quant=None, device=device)


@register("c2c-direct-mixed")
def _c2c_direct_mixed(device):
    return _make_recognizer(tta=False, device=device)


@register("c2c-direct-mixed-tta")
def _c2c_direct_mixed_tta(device):
    return _make_recognizer(tta=True, device=device)


@register("fastconformer-zeroshot")
def _fastconformer_zeroshot(device):
    """Greedy decode + text match_verse only, no CTC rerank (reference:
    experiments/nvidia-fastconformer/run.py:167-236 zero-shot baseline)."""
    return _make_recognizer(tta=False, rerank_mode="never", device=device)


@register("ctc-alignment")
def _ctc_alignment(device):
    """Forced-alignment rerank of every candidate, gate disabled (reference:
    experiments/ctc-alignment/run.py + ctc_scorer.py:14-98)."""
    return _make_recognizer(tta=False, rerank_mode="always", device=device)


@functools.lru_cache(maxsize=1)
def _refs_by_file() -> dict[str, tuple[tuple[int, int, None], ...]]:
    from tilawa_tpu_torch.eval.runner import CORPUS_DIRS

    refs_by_file: dict[str, tuple[tuple[int, int, None], ...]] = {}
    for key in ("v1", "v2", "v3"):
        mpath = CORPUS_DIRS[key] / "manifest.json"
        if not mpath.exists():
            continue
        with open(mpath, encoding="utf-8") as f:
            data = json.load(f)
        for s in data["samples"] if isinstance(data, dict) else data:
            refs = tuple(
                (e["surah"], e["ayah"], None)
                for e in s.get("expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}])
            )
            refs_by_file.setdefault(s["file"], refs)
    return refs_by_file


def manifest_refs_for(path: str | Path) -> list[tuple[int, int, int | None]]:
    """Ground-truth verse refs for a corpus audio file (any corpus),
    resolved from the manifests; used by oracle-acoustics experiments."""
    fname = Path(path).name
    refs = _refs_by_file().get(fname)
    if refs is None:
        raise KeyError(f"no manifest entry for {fname}")
    return list(refs)


class OracleExperiment:
    """Champion decision stack over synthetic acoustics.

    predict(path) resolves the sample's ground-truth refs from the corpus
    manifest, renders CTC log-probs with the configured corruption level
    (OracleRuntime, numpy) and runs the text + rerank pipeline, the rerank
    on `device`. Audio files are never decoded; only their manifest entries
    matter.
    """

    acoustics = "oracle"  # simulation marker, carried into results rows

    def __init__(
        self, error_rate: float = 0.0, noise: float = 0.3, seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        from tilawa_tpu_torch.data.assets import BLANK_ID
        from tilawa_tpu_torch.data.quran import QuranDB
        from tilawa_tpu_torch.data.token_store import TokenStore
        from tilawa_tpu_torch.pipeline.predict import Recognizer
        from tilawa_tpu_torch.pipeline.runtime import OracleRuntime

        self.db = QuranDB()
        self.token_store = TokenStore.load_default()

        def lookup(surah, ayah, ayah_end):
            ids = self.token_store.ids_for_key(surah, ayah, ayah_end)
            if ids is None:
                text = self.db.span_text(surah, ayah, ayah_end or ayah)
                ids = self.token_store.ids_for_text(text) if text else []
            return ids

        self.runtime = OracleRuntime(
            lookup, blank_id=BLANK_ID, noise=noise, error_rate=error_rate, seed=seed
        )
        self.recognizer = Recognizer(
            self.runtime, db=self.db, token_store=self.token_store, device=device
        )

    def predict(self, path: str) -> dict:
        lp, t = self.runtime.render(manifest_refs_for(path))
        return self.recognizer._predict_from_logprobs(lp, t)

    def transcribe(self, path: str) -> str:
        lp, t = self.runtime.render(manifest_refs_for(path))
        return self.recognizer.greedy_decode(lp, t)

    def model_size(self) -> int:
        return 0


class LMFusionExperiment(OracleExperiment):
    """Champion stack + n-gram shallow-fusion rescoring of the candidate
    list (reference: experiments/fastconformer-quran-lm-fusion/run.py —
    KenLM alpha 0.7 / beta 1.0; the LM is text/ngram.py over the same
    corpus asset). With a shipped checkpoint the base predictions come from
    the real champion (acoustics "real"); without one, from the synthetic
    oracle stack, labelled acoustics "oracle", as in the JAX package."""

    def __init__(self, alpha: float = 0.7, beta: float = 1.0,
                 device: str | torch.device = "cuda", **kw):
        super().__init__(device=device, **kw)
        from tilawa_tpu_torch.text.ngram import NGramLM

        self.lm = NGramLM.from_corpus_file(order=5)
        self.alpha, self.beta = alpha, beta
        # the champion Recognizer behind the base predictions (None: oracle)
        self.real = None
        if shipped_checkpoint() is not None:
            self.real = _make_recognizer(tta=False, device=device)
            self.acoustics = "real"

    def transcribe(self, path: str) -> str:
        if self.real is not None:
            return self.real.transcribe(path)
        return super().transcribe(path)

    def model_size(self) -> int:
        return self.real.model_size() if self.real is not None else 0

    def predict(self, path: str) -> dict:
        from tilawa_tpu_torch.text.ngram import lm_rescore

        result = self.real.predict(path) if self.real is not None else super().predict(path)
        cands = result.get("candidates") or []
        if len(cands) > 1:
            texts = [
                {**c, "text": self.db.span_text(
                    c["surah"], c["ayah"], c.get("ayah_end") or c["ayah"]) or ""}
                for c in cands
            ]
            fused = lm_rescore(texts, self.lm, self.alpha, self.beta)
            best = fused[0]
            result = {
                **result,
                "surah": best["surah"],
                "ayah": best["ayah"],
                "ayah_end": best.get("ayah_end") or best["ayah"],
                "candidates": fused[:5],
            }
        return result


def _pruned_runtime(keep: int, mode: str, device) -> EncoderRuntime:
    """The shipped checkpoint pruned to `keep` blocks on `device`."""
    from tilawa_tpu_torch.train.prune import prune_layers

    config, variables, _label = load_shipped()
    config, variables = prune_layers(config, variables, keep, mode)
    return EncoderRuntime(config, variables, device=device)


class PrunedCTCExperiment:
    """Depth-pruned encoder variants behind the reference's list_models()
    multi-variant contract (reference: experiments/rabah-pruned-ctc/run.py
    list_models() over 12/8/6-layer first_n / evenly_spaced prunes;
    benchmark/runner.py:162-190 expands them). A variant is pruned from the
    shipped checkpoint when it is first used."""

    VARIANTS = {
        f"L{keep}-{mode}": (keep, mode)
        for keep in (12, 8, 6)
        for mode in ("first_n", "evenly_spaced")
    }

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = device
        self._recognizers: dict[str, object] = {}
        self._current = "L12-evenly_spaced"

    def list_models(self) -> list[str]:
        return sorted(self.VARIANTS)

    def set_model(self, name: str) -> None:
        if name not in self.VARIANTS:
            raise KeyError(f"unknown model {name!r}; have {self.list_models()}")
        self._current = name

    def _recognizer(self):
        name = self._current
        if name not in self._recognizers:
            from tilawa_tpu_torch.pipeline.predict import Recognizer

            self._recognizers[name] = Recognizer(
                _pruned_runtime(*self.VARIANTS[name], resolve_device(self.device)))
        return self._recognizers[name]

    @property
    def runtime(self) -> EncoderRuntime:
        return self._recognizer().runtime

    def predict(self, path: str) -> dict:
        return self._recognizer().predict(path)

    def transcribe(self, path: str) -> str:
        return self._recognizer().transcribe(path)

    def model_size(self) -> int:
        return self._recognizer().model_size()


class TwoStageExperiment:
    """Two-stage ASR → CTC-rescore pipeline (reference: experiments/two-stage/
    run.py and two-stage-faster-whisper-pruned/run.py — a cheap generic ASR
    produces the transcript that drives candidate retrieval, then a separate
    CTC model rescores the candidates acoustically).

    Stage 1 transcribes with a depth-pruned encoder: TILAWA_STAGE1_CHECKPOINT
    or exports/pruned-L{stage1_layers} when present, else the shipped
    checkpoint pruned to stage1_layers blocks, evenly spaced. Stage 2 builds
    candidates from that transcript and CTC-reranks them against the full
    champion's log-probs with the gate off (rerank_mode="always")."""

    def __init__(self, stage1_layers: int = 12, device: str | torch.device = "cuda"):
        self.stage1_layers = stage1_layers
        self.device = device
        self._stage1 = None
        self._stage2 = None

    def _build(self):
        if self._stage2 is not None:
            return
        from tilawa_tpu_torch.pipeline.predict import Recognizer

        device = resolve_device(self.device)
        ft = Path(os.getenv("TILAWA_STAGE1_CHECKPOINT",
                            str(EXPORTS_DIR / f"pruned-L{self.stage1_layers}")))
        if ft.exists():
            config, variables = load_variables(ft)
            stage1 = EncoderRuntime(config, variables, device=device)
        else:
            stage1 = _pruned_runtime(self.stage1_layers, "evenly_spaced", device)
        self._stage1 = Recognizer(stage1)
        self._stage2 = _make_recognizer(tta=False, rerank_mode="always", device=device)

    @property
    def stages(self) -> tuple:
        """(stage-1 Recognizer, stage-2 Recognizer), built on first use."""
        self._build()
        return self._stage1, self._stage2

    def predict(self, path: str) -> dict:
        from tilawa_tpu_torch.data.audio import load_audio

        self._build()
        audio = load_audio(path)
        transcript = self._stage1.transcribe_audio(audio)
        lp, _ids, t_valid = self._stage2.runtime.forward(audio)
        result = self._stage2._predict_from_logprobs(lp, t_valid, transcript)
        result["stage1_transcript"] = transcript
        return result

    def transcribe(self, path: str) -> str:
        self._build()
        return self._stage1.transcribe(path)

    def model_size(self) -> int:
        self._build()
        return self._stage1.model_size() + self._stage2.model_size()


def _phoneme_checkpoint() -> Path | None:
    """TILAWA_PHONEME_CKPT, else the shipped phoneme bundle
    (exports/phoneme-int8), else the newest step of checkpoints/phoneme
    (train/phoneme.py), else None."""
    env = os.getenv("TILAWA_PHONEME_CKPT")
    if env:
        return Path(env)
    shipped = EXPORTS_DIR / "phoneme-int8"
    if (shipped / "variables.msgpack").exists():
        return shipped
    steps = sorted((CHECKPOINT_DIR / "phoneme").glob("step_*"))
    return steps[-1] if steps else None


class PhonemeExperiment:
    """Phoneme pipeline (reference: experiments/fastconformer-phoneme/
    run.py — 69-token CTC head + mispronunciation detection). Runs the
    phoneme bundle on an EncoderRuntime on `device` when one exists
    (_phoneme_checkpoint), else synthetic phoneme acoustics rendered on the
    host (PhonemeOracleRuntime, seed 0) with acoustics="oracle" in every
    results row, as the JAX package does; oracle=True takes them even where
    a bundle exists. With TILAWA_PHONEME_RERANK set, the CTC rerank of
    phoneme candidates runs on `device`."""

    def __init__(self, device: str | torch.device = "cuda", oracle: bool = False):
        from tilawa_tpu_torch.data.phonemes import PhonemeStore
        from tilawa_tpu_torch.pipeline.phoneme import PhonemeOracleRuntime, PhonemePipeline

        self.device = resolve_device(device)
        ckpt = None if oracle else _phoneme_checkpoint()
        if ckpt is not None:
            config, variables = load_variables(ckpt)
            self.runtime = EncoderRuntime(config, variables, device=self.device)
            self.store = PhonemeStore.load_default()
            self.acoustics = "real"
        else:
            self.runtime = PhonemeOracleRuntime(noise=0.3)
            self.store = self.runtime.store
            self.acoustics = "oracle"
        self.pipeline = PhonemePipeline(self.runtime, store=self.store)

    def transcribe(self, path: str) -> str:
        if self.acoustics == "oracle":
            raise NotImplementedError(
                "phoneme transcribe requires trained weights or oracle refs"
            )
        return self.pipeline.transcribe_phonemes(path)

    def _peel_sequence(
        self, phonemes: str, max_verses: int = 12
    ) -> list[tuple[int, int, float]]:
        """Multi-verse phoneme decoding: repeatedly match the HEAD of the
        remaining phoneme string against verse reference strings (with a
        continuation bonus), emit, and trim the matched prefix — the
        phoneme-space analogue of the full-transcript peel-off loop
        (reference: shared/streaming.py:57-99; w2v-phonemes chunking +
        voting, experiments/w2v-phonemes/run.py:234-293). A single whole-
        verse clip degenerates to one iteration."""
        from tilawa_tpu_torch.text.levenshtein import ratio

        # Every surah's verse-1 ref embeds the bismillah; a recited
        # bismillah otherwise matches 1:1 (whose ref IS the bismillah)
        # and the stripped remainder then misses (s,1) refs that still
        # carry the prefix. Score both variants.
        bsm = self.store.refs.get((1, 1), "")

        def variants(s: int, a: int, ref: str) -> list[str]:
            if a == 1 and bsm and ref.startswith(bsm) and len(ref) > len(bsm):
                return [ref, ref[len(bsm):].strip(" |")]
            return [ref]

        out: list[tuple[int, int, float]] = []
        remaining = phonemes.strip()
        hint: tuple[int, int] | None = None
        pending_bsm = False
        while len(remaining.split()) >= 4 and len(out) < max_verses:
            # Candidates from the full remainder AND a head window: the
            # full-string ratio buries short verse-1 refs under a long
            # multi-verse tail (36:1 ranked nowhere for a 5-verse string).
            pool = {
                (c["surah"], c["ayah"])
                for c in self.store.match_verse(remaining, top_k=40)
            }
            if len(remaining) > 120:
                pool |= {
                    (c["surah"], c["ayah"])
                    for c in self.store.match_verse(remaining[:120], top_k=40)
                }
                pool |= {
                    (c["surah"], c["ayah"])
                    for c in self.store.match_verse(remaining[:60], top_k=20)
                }
            if hint and (hint[0], hint[1] + 1) in self.store.refs:
                pool.add((hint[0], hint[1] + 1))
            # Rarity 5-gram surah voting widens the pool with verses the
            # edit-ratio scan buries under length mismatch (reference:
            # w2v-phonemes/run.py:234-293).
            for v in self.store.ngram_vote(remaining[:160]):
                for a in range(v["ayah"], min(v["ayah_end"], v["ayah"] + 7) + 1):
                    if (v["surah"], a) in self.store.refs:
                        pool.add((v["surah"], a))
            best = None
            # the pool is a set: its iteration order is Python's hash order
            # of int tuples, the same in both packages, so ties break alike
            for (s, a) in pool:
                base_ref = self.store.refs.get((s, a)) or ""
                if not base_ref:
                    continue
                for ref in variants(s, a, base_ref):
                    pr = ratio(remaining[: len(ref) + 8], ref)
                    bonus = (
                        0.15 if hint and (s, a) == (hint[0], hint[1] + 1)
                        else 0.0
                    )
                    if best is None or pr + bonus > best[0]:
                        best = (pr + bonus, pr, s, a, ref)
            if best is None or best[1] < 0.45:
                break
            _, pr, s, a, ref = best
            if (s, a) == (1, 1) and not hint:
                # A leading pure-bismillah read may be surah preamble, not
                # Fatiha: hold it; emit only if surah 1 actually continues.
                pending_bsm = True
            else:
                if pending_bsm:
                    if (s, a) == (1, 2):
                        out.append((1, 1, pr))
                    pending_bsm = False
                out.append((s, a, pr))
            lo = max(1, int(len(ref) * 0.6))
            hi = min(len(remaining), int(len(ref) * 1.4) + 4)
            cut, cbest = min(hi, len(remaining)), -1.0
            step = max(1, (hi - lo) // 24)
            for c in range(lo, hi + 1, step):
                r = ratio(remaining[:c], ref)
                if r > cbest:
                    cbest, cut = r, c
            remaining = remaining[cut:].strip()
            hint = (s, a)
        if pending_bsm and not out:
            out.append((1, 1, 0.5))
        return out

    def _ctc_rerank_phonemes(
        self, lp, t_valid: int, phonemes: str,
        seq: list[tuple[int, int, float]],
    ) -> dict | None:
        """Forced-alignment rerank of verse/span candidates against the
        phoneme log-probs — the champion's decisive stage (reference:
        c2c-direct/run.py:314-380) applied in phoneme space, the lattice
        on the experiment's device."""
        import math

        from tilawa_tpu_torch.device import upload
        from tilawa_tpu_torch.ops.ctc import pad_frames
        from tilawa_tpu_torch.pipeline import rerank

        cands: list[tuple[int, int, int | None]] = []
        seen: set[tuple] = set()

        def add(s: int, a: int, a_end: int | None) -> None:
            if a_end is not None and a_end <= a:
                a_end = None
            key = (s, a, a_end)
            if key in seen or (s, a) not in self.store.refs:
                return
            if a_end is not None and (s, a_end) not in self.store.refs:
                return
            seen.add(key)
            cands.append(key)

        singles = self.store.match_verse(phonemes, top_k=12)
        for c in singles:
            add(c["surah"], c["ayah"], None)
        for v in self.store.ngram_vote(phonemes):
            a_end = min(v["ayah_end"], v["ayah"] + 7)
            add(v["surah"], v["ayah"], a_end if a_end > v["ayah"] else None)
            add(v["surah"], v["ayah"], None)
        if seq:
            s0, a0, _ = seq[0]
            add(s0, a0, None)
            ayahs = [a for s, a, _sc in seq if s == s0]
            if ayahs == list(range(a0, a0 + len(seq))) and len(seq) > 1:
                add(s0, a0, ayahs[-1])
        # span enumeration around the single-verse leaders
        for c in singles[:4]:
            for k in range(1, 6):
                add(c["surah"], c["ayah"], c["ayah"] + k)
            for back in range(1, 3):  # the leader may be mid-span
                a0 = c["ayah"] - back
                if a0 >= 1:
                    add(c["surah"], a0, c["ayah"])
        if not cands:
            return None
        token_lists = [self.store.verse_ids(s, a, a_end) for s, a, a_end in cands]
        if self.device.type != "cpu":
            padded, _t = pad_frames(np.asarray(lp[:t_valid], dtype=np.float32))
            lp = upload(padded, self.device)
        scores = rerank.score_token_lists(
            lp, t_valid, token_lists, blank_id=self.store.blank_id
        )
        best = None
        for (s, a, a_end), nll in zip(cands, scores):
            if not np.isfinite(nll):
                continue
            span = (a_end - a + 1) if a_end else 1
            final = -float(nll) - rerank.SPAN_PENALTY * (span - 1)
            if best is None or final > best[0]:
                best = (final, float(nll), s, a, a_end)
        if best is None:
            return None
        _final, nll, s, a, a_end = best
        return {
            "surah": s, "ayah": a, "ayah_end": a_end,
            "score": math.exp(-nll) if math.isfinite(nll) else 0.0,
            "transcript": phonemes, "source": "phoneme-ctc",
        }

    def predict(self, path: str) -> dict:
        """Phoneme decode → phoneme-space retrieval → (with
        TILAWA_PHONEME_RERANK) CTC forced-alignment rerank (reference:
        experiments/w2v-phonemes/run.py Levenshtein over quran_phonemes.json
        + the champion's rerank stage)."""
        from tilawa_tpu_torch.text.levenshtein import ratio

        if self.acoustics == "oracle":
            # synthetic path: render corrupted phoneme log-probs for the
            # sample's true refs (marked acoustics='oracle' in results)
            surah, ayah, _ = manifest_refs_for(path)[0]
            lp, t = self.runtime.render(surah, ayah)
        else:
            from tilawa_tpu_torch.data.audio import load_audio

            lp, t = self.runtime.log_probs(load_audio(path))
        phonemes = self.store.decode_logprobs(lp, t)
        seq = self._peel_sequence(phonemes)
        reranked = (
            self._ctc_rerank_phonemes(lp, t, phonemes, seq)
            if os.getenv("TILAWA_PHONEME_RERANK", "") not in ("", "0")
            else None
        )
        if len(seq) > 1:
            s0, a0, _ = seq[0]
            ayahs = [a for s, a, _sc in seq if s == s0]
            contiguous = (
                len(ayahs) == len(seq)
                and ayahs == list(range(a0, a0 + len(seq)))
            )
            if contiguous:
                # the peel can cover arbitrarily long recitations; the
                # rerank's span enumeration caps at 8 ayahs — only let the
                # rerank override when it covers at least as much
                r_span = (
                    (reranked["ayah_end"] or reranked["ayah"])
                    - reranked["ayah"] + 1
                ) if reranked else 0
                if reranked and r_span >= len(seq):
                    return reranked
                return {
                    "surah": s0, "ayah": a0,
                    "ayah_end": ayahs[-1],
                    "score": sum(sc for _s, _a, sc in seq) / len(seq),
                    "transcript": phonemes,
                }
        if reranked is not None:
            return reranked
        matches = self.store.match_verse(phonemes, top_k=5)
        # Vote-seeded span candidates: score each top rarity-vote run as a
        # whole span against the full phoneme string; a run that reads
        # better than the single-verse leader becomes the match.
        for v in self.store.ngram_vote(phonemes):
            a_end = min(v["ayah_end"], v["ayah"] + 7)
            ref = self.store.reference_phonemes(v["surah"], v["ayah"], a_end)
            if not ref:
                continue
            sc = ratio(phonemes, ref)
            if not matches or sc > matches[0]["score"]:
                matches.insert(0, {
                    "surah": v["surah"], "ayah": v["ayah"],
                    "ayah_end": a_end if a_end > v["ayah"] else None,
                    "score": sc,
                })
        if seq and (not matches or seq[0][2] >= matches[0]["score"]):
            s0, a0, sc = seq[0]
            matches = [{"surah": s0, "ayah": a0, "score": sc}] + matches
        if not matches:
            return {"surah": 0, "ayah": 0, "ayah_end": None, "score": 0.0,
                    "transcript": phonemes}
        best = matches[0]
        return {
            "surah": best["surah"], "ayah": best["ayah"],
            "ayah_end": best.get("ayah_end"),
            "score": best["score"], "transcript": phonemes,
            "candidates": matches,
        }

    def detect_mispronunciations(self, surah: int, ayah: int) -> dict:
        if self.acoustics == "oracle":
            lp, t = self.runtime.render(surah, ayah)
            predicted = self.store.decode_logprobs(lp, t)
            return self.store.detect_mispronunciations(predicted, surah, ayah)
        raise NotImplementedError(
            "use pipeline.detect_mispronunciations(audio_path, ...) with "
            "real weights"
        )

    def model_size(self) -> int:
        if self.acoustics == "real":
            from tilawa_tpu_torch.models.convert import packed_size_bytes

            return packed_size_bytes(self.runtime.variables)
        return 0


@register("two-stage")
def _two_stage(device):
    return TwoStageExperiment(device=device)


@register("pruned-ctc")
def _pruned_ctc(device):
    return PrunedCTCExperiment(device=device)


@register("fastconformer-quran-lm-fusion")
def _lm_fusion(device):
    return LMFusionExperiment(error_rate=0.10, noise=1.0, device=device)


@register("fastconformer-phoneme")
def _fastconformer_phoneme(device):
    return PhonemeExperiment(device=device)


@register("oracle")
def _oracle(device):
    return OracleExperiment(error_rate=0.0, noise=0.3, device=device)


@register("oracle-hard")
def _oracle_hard(device):
    return OracleExperiment(error_rate=0.10, noise=1.0, device=device)


def _heldout_checkpoint() -> Path | None:
    """Newest artifact of the held-out campaign: TILAWA_HELDOUT_CKPT, else
    exports/heldout-int4 if exported, else the highest-step checkpoint of
    the newest campaign phase (checkpoints/heldout2, then heldout)."""
    env = os.getenv("TILAWA_HELDOUT_CKPT")
    if env:
        return Path(env)
    export = EXPORTS_DIR / "heldout-int4"
    if (export / "variables.msgpack").exists():
        return export
    for run in ("heldout2", "heldout"):
        steps = sorted((CHECKPOINT_DIR / run).glob("step_*"))
        if steps:
            return steps[-1]
    return None


@register("heldout")
def _heldout(device):
    """Champion pipeline on the held-out model: trained from scratch on
    v2+v3 audio only, so its v1 score is the generalization-honest one
    (the shipped champion declares train==test overlap)."""
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    ckpt = _heldout_checkpoint()
    if ckpt is None:
        raise FileNotFoundError(
            "no held-out artifact (exports/heldout-int4 or TILAWA_HELDOUT_CKPT)"
        )
    config, variables = load_variables(ckpt)
    return Recognizer(EncoderRuntime(config, variables, device=resolve_device(device)), tta=True)
