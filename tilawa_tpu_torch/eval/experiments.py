"""Experiment registry and runtime loading for the port.

Port of tilawa_tpu/eval/experiments.py:27-230, 766-773. Experiments are
lazy factories of pipeline objects with predict()/transcribe(), built on a
device (the card unless the caller passes device="cpu") and cached per
(name, device):

  c2c-direct              the shipped checkpoint as it is, gated rerank
  c2c-direct-tta          + confidence-gated 0.9x/1.1x TTA
  c2c-direct-mixed        repacked to int4 where the bundle is not int4
  c2c-direct-mixed-tta    the champion: int4, gated rerank, TTA
  fastconformer-zeroshot  greedy decode + text match, never a CTC rerank
  ctc-alignment           CTC rerank of every candidate
  oracle / oracle-hard    the decision stack over log-probs rendered from
                          the manifest's ground truth (no audio decoded)

load_runtime(path) puts any bundle (exports/stream6-int8 for streaming)
on an EncoderRuntime; load_champion() is the shipped checkpoint,
exports/champion-int4 unless TILAWA_CHECKPOINT names another. The other
experiment families (phoneme, LM fusion, pruned, two-stage, heldout) are
queued in ROADMAP A.4.
"""

from __future__ import annotations

import functools
import json
import os
from pathlib import Path

import torch

from tilawa_tpu_torch.device import resolve_device
from tilawa_tpu_torch.io.bundle import load_variables, shipped_checkpoint
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


@register("oracle")
def _oracle(device):
    return OracleExperiment(error_rate=0.0, noise=0.3, device=device)


@register("oracle-hard")
def _oracle_hard(device):
    return OracleExperiment(error_rate=0.10, noise=1.0, device=device)
