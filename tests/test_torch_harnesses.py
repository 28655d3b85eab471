"""The port's diagnostic harnesses against the JAX package's, on the CPU.

* context_sweep: token_edits / lcp_len equal on seeded id lists;
  sweep_sample's ids and run_sweep's tables equal on one v1 clip
  (champion-int4; JAX with use_pallas=False).
* stability: classify equal; run_stability on the oracle experiment gives
  the JAX package's report; run_single and stability write under the
  port's results_torch/, never benchmark/.
* tracker_oracle: the window→token mapping of tests/test_tracker_oracle.py
  (ids, text, rendered log-probs) equal to JAX's; one clip's oracle replay
  gives the same emissions and final sequence.
* analyze_results / compare_results / score_params on the JAX package's
  recorded streaming run give JAX's output.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from tilawa_tpu_torch.io.bundle import EXPORTS_DIR  # noqa: E402

REPO = EXPORTS_DIR.parent
CORPUS = REPO / "benchmark" / "test_corpus"
RESULTS = REPO / "benchmark" / "results"
STREAM_RUN = RESULTS / "2026-08-21_204047.json"      # tracker-streaming, v1, stream6-int8
BATCH_RUN = RESULTS / "2026-08-21_095830.json"       # c2c-direct-mixed-tta, v1
SWEEP_CLIP = "retasy_003"


# ----------------------------------------------------------- context sweep

def test_token_edits_and_lcp_equal_jax():
    from tilawa_tpu.eval import context_sweep as jsweep
    from tilawa_tpu_torch.eval import context_sweep as tsweep

    rng = np.random.default_rng(0)
    for _ in range(200):
        a = rng.integers(0, 6, rng.integers(0, 12)).tolist()
        b = rng.integers(0, 6, rng.integers(0, 12)).tolist()
        assert tsweep.token_edits(a, b) == jsweep.token_edits(a, b)
        assert tsweep.lcp_len(a, b) == jsweep.lcp_len(a, b)
        assert tsweep.lcp_len(a, a + b) == len(a)


@pytest.fixture(scope="module")
def sweeps():
    import dataclasses

    from tilawa_tpu.eval import context_sweep as jsweep
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval import context_sweep as tsweep
    from tilawa_tpu_torch.eval.experiments import load_champion

    cfg, variables = jax_load_variables(EXPORTS_DIR / "champion-int4")
    jax_rt = JaxRuntime(dataclasses.replace(cfg, use_pallas=False), variables)
    rt = load_champion("cpu")
    sample = next(s for s in tsweep.load_manifest("v1")[0] if s["id"] == SWEEP_CLIP)
    audio = load_audio(CORPUS / sample["file"])

    def one_sample(corpus):
        return [sample], CORPUS

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsweep, "load_manifest", one_sample)
        mp.setattr(tsweep, "load_manifest", one_sample)
        tables = (jsweep.run_sweep(jax_rt, verbose=False), tsweep.run_sweep(rt, verbose=False))
    return (jsweep.sweep_sample(jax_rt, audio), tsweep.sweep_sample(rt, audio)), tables


def test_sweep_sample_ids_equal_jax(sweeps):
    ref, ours = sweeps[0]
    assert list(ours) == list(ref) == ["1", "2", "3", "full"]
    for key in ref:
        assert ours[key] == ref[key], key
    assert ours["full"], "the full clip decodes to no tokens"


def test_run_sweep_tables_equal_jax(sweeps):
    ref, ours = sweeps[1]
    assert ours == ref
    assert ours["wer_vs_reference"]["full"]["n"] == 1


# --------------------------------------------------------------- stability

def test_classify_equals_jax():
    from itertools import product

    from tilawa_tpu.eval.stability import classify as jax_classify
    from tilawa_tpu_torch.eval.stability import classify

    for n in (1, 2, 3):
        for passes in product([True, False], repeat=n):
            assert classify(list(passes)) == jax_classify(list(passes))


def test_run_stability_on_oracle_equals_jax(monkeypatch):
    from tilawa_tpu.eval import experiments as jexp
    from tilawa_tpu.eval.stability import run_stability as jax_run
    from tilawa_tpu_torch.eval import experiments as texp
    from tilawa_tpu_torch.eval.stability import run_stability

    # fresh oracle experiments on both sides: their renderers draw from one RNG
    monkeypatch.setattr(jexp, "_CACHE", {})
    monkeypatch.setattr(texp, "_CACHE", {})
    ref = jax_run("oracle", category="multi", repeats=2)
    ours = run_stability("oracle", category="multi", repeats=2, device="cpu")
    assert ours == ref
    assert ours["samples"] > 0 and ours["deterministic"]


def test_harness_results_go_to_results_torch(monkeypatch, tmp_path, capsys):
    from tilawa_tpu_torch.eval import run_single, stability
    from tilawa_tpu_torch.eval.runner import RESULTS_DIR

    for path in (stability.RESULTS_DIR, run_single.EXPERIMENT_RESULTS_DIR):
        assert path.is_relative_to(RESULTS_DIR) and "benchmark" not in path.parts
    if "TILAWA_TORCH_RESULTS_DIR" not in os.environ:
        assert RESULTS_DIR == REPO / "results_torch"

    monkeypatch.setattr(stability, "RESULTS_DIR", tmp_path)
    assert stability.main(["--experiment", "oracle", "--category", "multi", "--repeats", "1",
                           "--device", "cpu"]) == 0
    report = json.loads(next(tmp_path.glob("stability_oracle_*.json")).read_text())
    assert report["deterministic"] and report["stable_pass"] == report["samples"] > 0

    monkeypatch.setattr(run_single, "EXPERIMENT_RESULTS_DIR", tmp_path / "experiment_results")
    for _ in range(2):
        run_single.run_single("oracle", category="multi", device="cpu")
    history = json.loads((tmp_path / "experiment_results" / "oracle.json").read_text())
    assert len(history) == 2 and history[-1]["sequence_accuracy"] == 1.0
    capsys.readouterr()


# ---------------------------------------------------------- tracker oracle

@pytest.mark.parametrize("fed,window,cut_mode", [
    (40000, 40000, "drop"), (60000, 30000, "drop"), (33000, 33000, "drop"),
    (33000, 33000, "garble"), (8000, 8000, "drop"), (52000, 20000, "garble"),
])
def test_window_mapping_equals_jax(fed, window, cut_mode):
    from tilawa_tpu.data.tokenizer import SentencePieceBPE as JaxBPE
    from tilawa_tpu.eval.tracker_oracle import OracleWindowTranscriber as JaxWindow
    from tilawa_tpu.pipeline.runtime import OracleRuntime as JaxOracleRuntime
    from tilawa_tpu_torch.data.tokenizer import SentencePieceBPE
    from tilawa_tpu_torch.eval.tracker_oracle import OracleWindowTranscriber
    from tilawa_tpu_torch.pipeline.runtime import OracleRuntime

    token_ids = np.array([10, 20, 30], np.int32)      # at 1 s, 2 s, 3 s, 0.2 s each
    starts = np.array([16000, 32000, 48000], np.int64)
    ends = starts + 3200
    results = []
    for window_cls, runtime_cls, bpe in ((JaxWindow, JaxOracleRuntime, JaxBPE),
                                         (OracleWindowTranscriber, OracleRuntime,
                                          SentencePieceBPE)):
        renderer = runtime_cls(lambda *a: [], blank_id=1024, vocab_size=1025, noise=0.15, seed=0)
        tr = window_cls(token_ids, starts, ends, bpe.load_default(), renderer,
                        cut_mode=cut_mode, rng=np.random.default_rng(0))
        tr.on_chunk(fed)
        results.append(tr(np.zeros(window, np.float32)))
    ref, ours = results
    assert ours.token_ids == ref.token_ids and ours.text == ref.text
    assert ours.t_valid == ref.t_valid
    np.testing.assert_array_equal(ours.log_probs, np.asarray(ref.log_probs))


def test_oracle_replay_equals_jax():
    from tilawa_tpu.data.quran import QuranDB as JaxDB
    from tilawa_tpu.data.token_store import TokenStore as JaxStore
    from tilawa_tpu.data.tokenizer import SentencePieceBPE as JaxBPE
    from tilawa_tpu.eval import tracker_oracle as joracle
    from tilawa_tpu.eval.validate_streaming import run_validation as jax_validation
    from tilawa_tpu_torch.data.quran import QuranDB
    from tilawa_tpu_torch.data.token_store import TokenStore
    from tilawa_tpu_torch.data.tokenizer import SentencePieceBPE
    from tilawa_tpu_torch.eval import tracker_oracle as toracle
    from tilawa_tpu_torch.eval.validate_streaming import run_validation

    ids = {"retasy_010"}
    ref = jax_validation(None, ids=ids, db=JaxDB(), token_store=JaxStore.load_default(),
                         verbose=False, name="tracker-oracle-drop",
                         transcribe_factory=joracle.make_factory("v1", JaxBPE.load_default()))
    ours = run_validation(None, ids=ids, db=QuranDB(), token_store=TokenStore.load_default(),
                          verbose=False, name="tracker-oracle-drop",
                          transcribe_factory=toracle.make_factory("v1",
                                                                  SentencePieceBPE.load_default()))
    assert ours["total"] == ref["total"] == 1 and ours["acoustics"] == "oracle"
    a, b = ours["per_sample"][0], ref["per_sample"][0]
    assert a["final_sequence"] == b["final_sequence"] and a["final_sequence"]
    assert a["predicted"] == b["predicted"]
    assert a["sequence_accuracy"] == b["sequence_accuracy"]


def test_tracker_oracle_cli(capsys):
    from tilawa_tpu_torch.eval.tracker_oracle import main

    assert main(["--ids", "retasy_003"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["total"] == 1 and summary["name"] == "tracker-oracle-drop"
    assert summary["alignment_degenerate"] == []


# ------------------------------------------------ analyze / compare / sweep

def test_analyze_results_equal_jax():
    from tilawa_tpu.eval.analyze import analyze_results as jax_analyze
    from tilawa_tpu_torch.eval.analyze import analyze_results

    for path in (STREAM_RUN, BATCH_RUN):
        data = json.loads(path.read_text())
        assert analyze_results(data) == jax_analyze(data)
    assert analyze_results(json.loads(STREAM_RUN.read_text()))["total"] == 44


def test_compare_results_equal_jax():
    from tilawa_tpu.eval.compare import compare_results as jax_compare
    from tilawa_tpu_torch.eval.compare import compare_results

    batch, stream = json.loads(BATCH_RUN.read_text()), json.loads(STREAM_RUN.read_text())
    ours = compare_results(batch, stream)
    assert ours == jax_compare(batch, stream)
    assert ours["common_samples"] == 44


@pytest.mark.parametrize("overrides", [{}, {"skip_scale": 0.6}, {"skip_scale": 1.2}])
def test_score_params_equal_jax(overrides):
    import dataclasses

    from tilawa_tpu.eval import hypothesis_sweep as jhs
    from tilawa_tpu.streaming.config import HypothesisParams as JaxParams
    from tilawa_tpu_torch.eval import hypothesis_sweep as ths
    from tilawa_tpu_torch.streaming.config import HypothesisParams

    rows = ths.load_dumps([str(STREAM_RUN)])
    assert rows == jhs.load_dumps([str(STREAM_RUN)]) and rows
    ours = ths.score_params(rows, dataclasses.replace(HypothesisParams(), **overrides))
    ref = jhs.score_params(rows, dataclasses.replace(JaxParams(), **overrides))
    assert ours == ref
