"""The port's batched corpus eval against the JAX package's and against the
port's own per-clip path, on the CPU.

* variant_length: exact integers, equal to JAX's.
* small config (random JAX init converted, so every clip is low-confidence
  and takes the TTA pass): batched_corpus_eval(batch_size=2) over three
  seeded clips gives the JAX batched eval's predictions ((surah, ayah,
  ayah_end), transcript, source, TTA vote) and n_tta, and the port's
  per-clip predict_audio gives the same decisions; scores within 1e-4
  (4-decimal rounding of f32 CTC sums taken in another order).
* champion-int4 at full width: retasy_000 and retasy_016 (which takes the
  CTC rerank and the TTA vote) batched at B=2, equal to the per-clip
  decisions and to the JAX Recognizer's.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from tilawa_tpu_torch.eval.batched import batched_corpus_eval, variant_length  # noqa: E402
from tilawa_tpu_torch.io.bundle import EXPORTS_DIR  # noqa: E402

CORPUS = EXPORTS_DIR.parent / "benchmark" / "test_corpus"
KEY = ("surah", "ayah", "ayah_end")
DECISION = KEY + ("transcript", "source", "tta", "tta_preds")


def _decision(pred: dict) -> tuple:
    return tuple(pred.get(k) for k in DECISION)


@pytest.mark.parametrize("factor", [0.9, 1.1])
def test_variant_length_matches_jax(factor):
    from tilawa_tpu.eval.batched import variant_length as jax_variant_length
    from tilawa_tpu_torch.data.audio import speed_perturb

    ns = list(range(1, 400, 7)) + [16000, 63999, 64000, 64001, 255999, 1024000]
    for n in ns:
        assert variant_length(n, factor) == jax_variant_length(n, factor)
    for n in (1, 1000, 16001):
        assert variant_length(n, factor) == len(speed_perturb(np.zeros(n, np.float32), factor))
    assert variant_length(1234, 1.0) == 1234


@pytest.fixture(scope="module")
def small():
    from tilawa_tpu.eval.batched import batched_corpus_eval as jax_batched
    from tilawa_tpu.models.fastconformer import FastConformerConfig as JaxConfig
    from tilawa_tpu.pipeline.predict import Recognizer as JaxRecognizer
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu_torch.models.fastconformer import FastConformerConfig
    from tilawa_tpu_torch.pipeline.predict import Recognizer
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime

    jax_rt = JaxRuntime(JaxConfig.small(use_pallas=False))
    variables = jax.tree_util.tree_map(np.asarray, jax_rt.variables)
    rec = Recognizer(EncoderRuntime(FastConformerConfig.small(), variables, device="cpu"), tta=True)
    rng = np.random.default_rng(0)
    audios = [
        (f"s{i}", (0.05 * rng.standard_normal(n)).astype(np.float32), [{"surah": 1, "ayah": 1}])
        for i, n in enumerate((32000, 20000, 70000))
    ]
    ref = jax_batched(JaxRecognizer(jax_rt, tta=True), audios, batch_size=2)
    ours = batched_corpus_eval(rec, audios, batch_size=2)
    per_clip = {sid: rec.predict_audio(a) for sid, a, _e in audios}
    return ref, ours, per_clip


def test_small_batched_matches_jax(small):
    ref, ours, _ = small
    assert ours["n"] == ref["n"] == 3
    assert ours["n_tta"] == ref["n_tta"] == 3
    for sid, pred in ours["predictions"].items():
        assert _decision(pred) == _decision(ref["predictions"][sid]), sid
        assert pred["score"] == pytest.approx(ref["predictions"][sid]["score"], abs=1e-4)
    for k in ("recall", "precision", "seq_acc"):
        assert ours[k] == ref[k]


def test_small_batched_matches_per_clip(small):
    _, ours, per_clip = small
    for sid, pred in ours["predictions"].items():
        assert _decision(pred) == _decision(per_clip[sid]), sid
        assert pred["score"] == pytest.approx(per_clip[sid]["score"], abs=1e-4)


def test_batched_reports_its_stages(small):
    _, ours, _ = small
    for k in ("wall_s", "fetch_wait_s", "decode_s", "predict_s", "audio_sec_per_sec"):
        assert ours[k] is not None and ours[k] >= 0
    assert ours["audio_s"] == round((32000 + 20000 + 70000) / 16000, 1)


@pytest.fixture(scope="module")
def champion():
    from tilawa_tpu.pipeline.predict import Recognizer as JaxRecognizer
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.experiments import load_champion
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    clips = ("retasy_000", "retasy_016")
    audios = [(c, load_audio(CORPUS / f"{c}.wav"), [{"surah": 0, "ayah": 0}]) for c in clips]
    rec = Recognizer(load_champion("cpu"), tta=True)
    batched = batched_corpus_eval(rec, audios, batch_size=2)
    per_clip = {c: rec.predict_audio(a) for c, a, _e in audios}
    cfg, variables = jax_load_variables(EXPORTS_DIR / "champion-int4")
    jax_rec = JaxRecognizer(JaxRuntime(dataclasses.replace(cfg, use_pallas=False), variables),
                            tta=True)
    jax_per_clip = {c: jax_rec.predict_audio(a) for c, a, _e in audios}
    return batched, per_clip, jax_per_clip


@pytest.mark.parametrize("clip", ["retasy_000", "retasy_016"])
def test_champion_batched_equals_per_clip_and_jax(champion, clip):
    batched, per_clip, jax_per_clip = champion
    pred = batched["predictions"][clip]
    assert _decision(pred) == _decision(per_clip[clip])
    assert tuple(pred[k] for k in KEY) == tuple(jax_per_clip[clip][k] for k in KEY)
    assert pred["transcript"] == jax_per_clip[clip]["transcript"]


def test_champion_batched_ran_tta_on_the_hard_clip(champion):
    batched, _, _ = champion
    assert batched["n_tta"] == 1
    assert batched["predictions"]["retasy_016"]["source"] == "ctc"
    assert batched["predictions"]["retasy_016"].get("tta") is not None
    assert batched["predictions"]["retasy_000"].get("tta") is None
