"""The port's experiment registry, Recognizer modes, runner, streaming
pipeline and counts against the JAX package's, on the CPU.

Tolerances: the small fp32 config's log-probs within 1e-5 of JAX's on
seeded noise (same f32 algorithm, sums in another order; measured 4.8e-6);
oracle scores within 1e-4 (both round to 4 decimals after an f32 CTC
forward summed in another order); forward_flops relative 1e-12 (the same
float64 arithmetic); count_params and the quantized leaves exact.
Decisions — (surah, ayah, ayah_end), greedy ids, emissions — are equal.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from tilawa_tpu_torch.eval import experiments as texp  # noqa: E402
from tilawa_tpu_torch.eval import runner as trunner  # noqa: E402
from tilawa_tpu_torch.io.bundle import EXPORTS_DIR  # noqa: E402

REPO = EXPORTS_DIR.parent
CORPUS = REPO / "benchmark" / "test_corpus"
PORTED = (
    "c2c-direct", "c2c-direct-mixed", "c2c-direct-mixed-tta", "c2c-direct-tta",
    "ctc-alignment", "fastconformer-phoneme", "fastconformer-quran-lm-fusion",
    "fastconformer-zeroshot", "heldout", "oracle", "oracle-hard", "pruned-ctc", "two-stage",
)
KEY = ("surah", "ayah", "ayah_end")
MODES = ("gated", "always", "never")


# ---------------------------------------------------------------- registry

def test_registry_holds_the_ported_experiments():
    from tilawa_tpu.eval.experiments import list_experiments as jax_list

    assert texp.list_experiments() == sorted(PORTED)
    assert set(PORTED) <= set(jax_list())


def test_get_experiment_caches_and_rejects_unknown():
    first = texp.get_experiment("oracle", device="cpu")
    assert texp.get_experiment("oracle", device="cpu") is first
    assert first.model_size() == 0 and first.acoustics == "oracle"
    with pytest.raises(KeyError):
        texp.get_experiment("no-such-experiment", device="cpu")


def test_experiments_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.OracleExperiment()
    with pytest.raises(RuntimeError, match="CUDA"):
        texp._load_runtime("int4")


def test_load_runtime_raises_without_a_checkpoint(monkeypatch):
    """No random-init fallback, unlike the JAX package."""
    monkeypatch.setattr(texp, "shipped_checkpoint", lambda: None)
    with pytest.raises(FileNotFoundError):
        texp._load_runtime("int4", device="cpu")


# ---------------------------------------------------- rerank modes (small)

@pytest.fixture(scope="module")
def small_pair():
    from tilawa_tpu.models.fastconformer import FastConformerConfig as JaxConfig
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu_torch.models.fastconformer import FastConformerConfig
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime

    jax_rt = JaxRuntime(JaxConfig.small(use_pallas=False))
    variables = jax.tree_util.tree_map(np.asarray, jax_rt.variables)
    rt = EncoderRuntime(FastConformerConfig.small(), variables, device="cpu")
    audio = (0.05 * np.random.default_rng(0).standard_normal(32000)).astype(np.float32)
    return jax_rt, rt, audio


def test_small_log_probs_match_jax(small_pair):
    jax_rt, rt, audio = small_pair
    ref, t_ref = jax_rt.log_probs(audio)
    ours, t = rt.log_probs(audio)
    assert t == t_ref
    np.testing.assert_allclose(ours[:t], ref[:t], atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_rerank_modes_match_jax(small_pair, mode):
    from tilawa_tpu.pipeline.predict import Recognizer as JaxRecognizer
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    jax_rt, rt, audio = small_pair
    ref = JaxRecognizer(jax_rt, rerank_mode=mode).predict_audio(audio)
    ours = Recognizer(rt, rerank_mode=mode).predict_audio(audio)
    assert ours["transcript"] == ref["transcript"] != ""
    assert tuple(ours[k] for k in KEY) == tuple(ref[k] for k in KEY)
    assert ours["source"] == ref["source"] == ("text" if mode == "never" else "ctc")
    assert ours["score"] == pytest.approx(ref["score"], abs=1e-4)


def test_rerank_mode_is_checked(small_pair):
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    with pytest.raises(ValueError):
        Recognizer(small_pair[1], rerank_mode="sometimes")


def test_profile_stages(small_pair, monkeypatch):
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    monkeypatch.setenv("TILAWA_PROFILE", "1")
    rec = Recognizer(small_pair[1], tta=True)
    rec.predict_audio(small_pair[2])
    assert {"forward", "decode", "build", "rerank", "tta", "audio_s"} <= set(rec.last_profile)
    assert rec.last_profile["audio_s"] == 2.0


# ------------------------------------------- full-width modes (champion)

@pytest.fixture(scope="module")
def champion_modes():
    """fastconformer-zeroshot ("never") and ctc-alignment ("always") on
    champion-int4, JAX and port, over two v1 clips (one JAX model)."""
    from tilawa_tpu.data.audio import load_audio
    from tilawa_tpu.pipeline.predict import Recognizer as JaxRecognizer
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    cfg, variables = jax_load_variables(EXPORTS_DIR / "champion-int4")
    jax_rt = JaxRuntime(dataclasses.replace(cfg, use_pallas=False), variables)
    rt = texp.load_champion("cpu")
    out = {}
    for clip in ("retasy_000.wav", "retasy_016.wav"):
        audio = load_audio(CORPUS / clip)
        _lp, ids_ref, t_ref = jax_rt.forward(audio)
        _lp, ids, t = rt.forward(audio)
        out[clip] = {"ids": (np.asarray(ids_ref)[:t_ref], ids[:t])}
        for mode in ("never", "always"):
            out[clip][mode] = (JaxRecognizer(jax_rt, rerank_mode=mode).predict_audio(audio),
                               Recognizer(rt, rerank_mode=mode).predict_audio(audio))
    return out


@pytest.mark.parametrize("clip", ["retasy_000.wav", "retasy_016.wav"])
@pytest.mark.parametrize("mode", ["never", "always"])
def test_champion_modes_match_jax(champion_modes, clip, mode):
    ref_ids, ids = champion_modes[clip]["ids"]
    np.testing.assert_array_equal(ids, ref_ids)
    ref, ours = champion_modes[clip][mode]
    assert tuple(ours[k] for k in KEY) == tuple(ref[k] for k in KEY)
    assert ours["source"] == ref["source"]


# ------------------------------------------------------ oracle + runner

def _six_samples():
    samples, corpus_dir = trunner.load_manifest("v1")
    return samples[:6], corpus_dir


@pytest.mark.parametrize("name,error_rate,noise", [
    ("oracle", 0.0, 0.3), ("oracle-hard", 0.10, 1.0),
])
def test_oracle_runner_matches_jax(name, error_rate, noise):
    from tilawa_tpu.eval.experiments import OracleExperiment as JaxOracle
    from tilawa_tpu.eval.runner import run_experiment as jax_run

    samples, corpus_dir = _six_samples()
    ref = jax_run(name, JaxOracle(error_rate=error_rate, noise=noise), samples, corpus_dir)
    exp = texp.OracleExperiment(error_rate=error_rate, noise=noise, device="cpu")
    ours = trunner.run_experiment(name, exp, samples, corpus_dir)
    assert ours["acoustics"] == ref["acoustics"] == "oracle"
    assert ours["model_size"] == 0
    assert ours["dispositions"] == ref["dispositions"]
    assert len(ours["per_sample"]) == len(ref["per_sample"]) > 0
    for a, b in zip(ours["per_sample"], ref["per_sample"]):
        assert a["id"] == b["id"]
        assert [(e["surah"], e["ayah"]) for e in a["predicted"]] == \
            [(e["surah"], e["ayah"]) for e in b["predicted"]], a["id"]
        for ea, eb in zip(a["predicted"], b["predicted"]):
            assert ea["score"] == pytest.approx(eb["score"], abs=1e-4)
        assert (a["recall"], a["precision"], a["sequence_accuracy"]) == \
            (b["recall"], b["precision"], b["sequence_accuracy"])
    for k in ("recall", "precision", "sequence_accuracy", "total", "skipped"):
        assert ours[k] == ref[k]


def test_manifest_refs_for():
    from tilawa_tpu.eval.experiments import manifest_refs_for as jax_refs

    for name in ("retasy_000.wav", "multi_113_001_005.wav", "long_033_056.wav"):
        assert texp.manifest_refs_for(CORPUS / name) == jax_refs(str(CORPUS / name))
    with pytest.raises(KeyError):
        texp.manifest_refs_for("nowhere.wav")


def test_runner_dispositions(tmp_path):
    """Absent and undecodable files each get their disposition and are not
    scored; a decodable clip is."""
    (tmp_path / "garbage.mp3").write_bytes(b"not audio at all" * 64)
    (tmp_path / "retasy_000.wav").write_bytes((CORPUS / "retasy_000.wav").read_bytes())
    samples = [
        {"id": "gone", "file": "gone.wav", "surah": 1, "ayah": 1},
        {"id": "bad", "file": "garbage.mp3", "surah": 1, "ayah": 1},
        {"id": "retasy_000", "file": "retasy_000.wav", "surah": 1, "ayah": 1},
    ]

    class Transcriber:
        """A transcribe-only pipeline: the runner's full-transcript path."""

        def transcribe(self, path):
            from tilawa_tpu_torch.data.audio import load_audio

            load_audio(path)
            return "بسم الله الرحمن الرحيم"

    from tilawa_tpu_torch.streaming.pipeline import StreamingPipeline

    out = trunner.run_experiment("t", Transcriber(), samples, tmp_path,
                                 streaming_pipeline=StreamingPipeline())
    status = {d["id"]: d["status"] for d in out["dispositions"]}
    assert status == {"gone": "file_absent", "bad": "undecodable"}
    assert out["total"] == 1 and out["skipped"] == 2 and out["total_manifest"] == 3
    assert out["sequence_accuracy"] == 1.0 and out["acoustics"] == "real"


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.floats(0, 10, allow_nan=False), max_size=40), st.floats(0, 1))
def test_percentile_matches_jax(values, q):
    from tilawa_tpu.eval.runner import _percentile as jax_percentile

    assert trunner._percentile(values, q) == jax_percentile(values, q)


def _row(name, seq_acc, latency):
    return {"name": name, "recall": seq_acc, "precision": seq_acc,
            "sequence_accuracy": seq_acc, "total": 3, "total_manifest": 3,
            "avg_latency": latency, "p50_latency": latency, "p90_latency": latency,
            "model_size": 0, "acoustics": "real"}


def test_save_results_merges_latest(tmp_path, monkeypatch):
    jax_results = REPO / "benchmark" / "results"
    before = sorted(p.name for p in jax_results.iterdir()) if jax_results.exists() else []
    monkeypatch.setattr(trunner, "RESULTS_DIR", tmp_path / "results_torch")
    trunner.save_results([_row("a", 0.5, 1.0)])
    trunner.save_results([_row("a", 1.0, 2.0), _row("b", 1.0, 1.0)])
    trunner.save_results([_row("a", 1.0, 3.0)])       # slower at equal accuracy: kept out
    latest = json.loads((tmp_path / "results_torch" / "latest.json").read_text())
    assert [(e["name"], e["sequence_accuracy"], e["avg_latency"]) for e in latest] == \
        [("a", 1.0, 2.0), ("b", 1.0, 1.0)]
    assert all(e["mode"] == "full" and e["source_file"].endswith(".json") for e in latest)
    after = sorted(p.name for p in jax_results.iterdir()) if jax_results.exists() else []
    assert after == before


def test_results_dir_is_the_ports_own(monkeypatch):
    """The default results directory is results_torch/, whatever the JAX
    runner's TILAWA_RESULTS_DIR says."""
    import importlib

    monkeypatch.delenv("TILAWA_TORCH_RESULTS_DIR", raising=False)
    monkeypatch.setenv("TILAWA_RESULTS_DIR", str(REPO / "benchmark" / "results"))
    try:
        assert importlib.reload(trunner).RESULTS_DIR == REPO / "results_torch"
    finally:
        monkeypatch.undo()
        importlib.reload(trunner)


def test_runner_list(capsys):
    trunner.main(["--list"])
    variants = [f"pruned-ctc/{m}" for m in sorted(texp.PrunedCTCExperiment.VARIANTS)]
    assert capsys.readouterr().out.split() == sorted(
        [n for n in PORTED if n != "pruned-ctc"] + variants)


def test_runner_cli_oracle_on_cpu(capsys):
    trunner.main(["--experiment", "oracle", "--device", "cpu", "--no-save",
                  "--category", "multi"])
    out = capsys.readouterr().out
    assert "oracle" in out and "100%" in out and "NOT saved" in out


# ------------------------------------------- streaming pipeline + tracker

TRANSCRIPTS = {
    # the JAX champion's greedy transcripts of three v1 clips (Recognizer.
    # transcribe on champion-int4, CPU), recorded here
    "retasy_000.wav": "بسم الله الرحمن الرحيم",
    "multi_113_001_005.wav": "قل اعوذ برب الفلق من شر ما خلق ومن شر غاسق اذا وقب "
                             "ومن شر النفثت في العقد ومن شر حاسد اذا حسد",
    "multi_103_001_003.wav": "والعصر ان الانسن لفي خسر الا الذين ءامنوا وعملوا "
                             "الصلحت وتواصوا بالحق وتواصوا بالصبر",
}


@pytest.mark.parametrize("clip", sorted(TRANSCRIPTS))
def test_full_transcript_peel_off_matches_jax(clip, quran_db):
    from tilawa_tpu.streaming.pipeline import StreamingPipeline as JaxPipeline
    from tilawa_tpu_torch.data.quran import QuranDB
    from tilawa_tpu_torch.streaming.pipeline import StreamingPipeline

    path = str(CORPUS / clip)
    ref = JaxPipeline(quran_db).run_on_full_transcript(path, lambda p: TRANSCRIPTS[clip])
    ours = StreamingPipeline(QuranDB()).run_on_full_transcript(path, lambda p: TRANSCRIPTS[clip])
    assert ours == ref and ours


def test_verse_tracker_snapshots_match_jax(quran_db):
    from tilawa_tpu.streaming.verse_tracker import VerseTracker as JaxTracker
    from tilawa_tpu_torch.data.quran import QuranDB
    from tilawa_tpu_torch.streaming.verse_tracker import VerseTracker

    words = TRANSCRIPTS["multi_113_001_005.wav"].split()
    snapshots = [" ".join(words[:i]) for i in range(2, len(words) + 1, 3)]
    for streaming in (False, True):
        ref, ours = JaxTracker(quran_db, streaming_mode=streaming), \
            VerseTracker(QuranDB(), streaming_mode=streaming)
        got_ref = [e for s in snapshots for e in ref.process_text(s)] + ref.finalize()
        got = [e for s in snapshots for e in ours.process_text(s)] + ours.finalize()
        assert got == got_ref and got


# ---------------------------------------------------------------- counts

def test_count_params_matches_jax():
    from tilawa_tpu.models.fastconformer import count_params as jax_count
    from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
    from tilawa_tpu_torch.io.bundle import load_variables
    from tilawa_tpu_torch.models.fastconformer import count_params

    _cfg, ref_vars = jax_load_variables(EXPORTS_DIR / "champion-int4")
    _cfg, variables = load_variables(EXPORTS_DIR / "champion-int4")
    assert count_params(variables) == jax_count(ref_vars) > 0
    assert count_params(variables["params"]) == jax_count(ref_vars["params"])


@pytest.mark.parametrize("seconds", [2.3, 16.0, 41.0])
def test_forward_flops_matches_jax(seconds):
    from tilawa_tpu.models.fastconformer import FastConformerConfig as JaxConfig
    from tilawa_tpu.models.fastconformer import forward_flops as jax_flops
    from tilawa_tpu_torch.io.bundle import load_variables
    from tilawa_tpu_torch.models.fastconformer import forward_flops

    cfg, _ = load_variables(EXPORTS_DIR / "champion-int4")
    ref = jax_flops(JaxConfig.large(quant="int4"), seconds)
    assert forward_flops(cfg, seconds) == pytest.approx(ref, rel=1e-12)


@pytest.fixture(scope="module")
def small_fp32_tree():
    from tilawa_tpu.models import fastconformer as jfc

    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((1, 16000)) * 0.1).astype(np.float32)
    model = jfc.FastConformerCTC(jfc.FastConformerConfig.small(use_pallas=False))
    return jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(3), jnp.asarray(audio), jnp.asarray([16000]))
    )


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("mode", ["int4", "mixed"])
def test_quantize_variables_matches_jax(small_fp32_tree, mode):
    from tilawa_tpu.train.quantize import quantize_variables as jax_quantize
    from tilawa_tpu_torch.train.quantize import quantize_variables, quantized_config

    ref = dict(_flat(jax.tree_util.tree_map(np.asarray, jax_quantize(small_fp32_tree, mode=mode))))
    ours = dict(_flat(quantize_variables(small_fp32_tree, mode=mode)))
    assert ours.keys() == ref.keys()
    for path, leaf in ours.items():
        assert isinstance(leaf, np.ndarray), path
        assert leaf.dtype == ref[path].dtype and leaf.shape == ref[path].shape, path
        assert np.array_equal(leaf.view(np.uint8), np.asarray(ref[path]).view(np.uint8)), path
    packed = [p for p in ours if p[-1] in ("packed", "q")]
    assert packed and not [p for p in ours if p[-1] == "kernel" and p[-2] in ("lin1", "q")]

    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.models.fastconformer import FastConformerCTC, FastConformerConfig

    load_into(FastConformerCTC(quantized_config(FastConformerConfig.small(), mode)),
              quantize_variables(small_fp32_tree, mode=mode))
