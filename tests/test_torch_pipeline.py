"""Port's champion pipeline vs the JAX package's, and the port's import
and device rules.

Recognizer(tta=True) decisions on v1 clips: two easy ones (text gate
passes) and retasy_016, whose 0.046 score sends it through the CTC rerank
and the 0.9x/1.1x TTA vote."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "benchmark" / "test_corpus"
CLIPS = ("retasy_000.wav", "retasy_002.wav", "retasy_016.wav")
FORBIDDEN = ("jax", "flax", "msgpack", "tilawa_tpu")


@pytest.fixture(scope="module")
def decisions():
    from tilawa_tpu.pipeline.predict import Recognizer as JaxRecognizer
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
    from tilawa_tpu_torch.eval.experiments import load_champion
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    cfg, variables = jax_load_variables(REPO / "exports" / "champion-int4")
    jax_rec = JaxRecognizer(
        JaxRuntime(dataclasses.replace(cfg, use_pallas=False), variables), tta=True
    )
    rec = Recognizer(load_champion("cpu"), tta=True)
    return [(jax_rec.predict(CORPUS / c), rec.predict(CORPUS / c)) for c in CLIPS], jax_rec, rec


@pytest.mark.parametrize("i", range(len(CLIPS)))
def test_recognizer_decisions_match_jax(decisions, i):
    ref, ours = decisions[0][i]
    key = ("surah", "ayah", "ayah_end")
    assert tuple(ours[k] for k in key) == tuple(ref[k] for k in key), CLIPS[i]
    assert ours["transcript"] == ref["transcript"]
    assert ours.get("source") == ref.get("source")
    assert ours.get("tta") == ref.get("tta")
    assert ours.get("tta_preds") == ref.get("tta_preds")
    assert ours["score"] == pytest.approx(ref["score"], abs=0.02)


def test_rerank_and_tta_were_exercised(decisions):
    _ref, ours = decisions[0][CLIPS.index("retasy_016.wav")]
    assert ours["source"] == "ctc" and ours.get("tta") is not None


def test_runtime_log_probs_match_jax(decisions):
    """The f32-upload entry point (log_probs, no int16 round trip)."""
    from tilawa_tpu.data.audio import load_audio
    from tilawa_tpu.ops.ctc import collapse_ctc

    _, jax_rec, rec = decisions
    audio = load_audio(CORPUS / CLIPS[1])
    ref, t_ref = jax_rec.runtime.log_probs(audio)
    ours, t_ours = rec.runtime.log_probs(audio)
    assert t_ours == t_ref and ours.shape[-1] == ref.shape[-1] == 1025
    assert collapse_ctc(ours[:t_ours].argmax(-1), 1024) == collapse_ctc(ref[:t_ref].argmax(-1), 1024)


@pytest.mark.parametrize("keys,scores", [
    ([(1, 1), (1, 1), (2, 3)], [0.2, 0.4, 0.9]),     # majority
    ([(1, 1), (2, 3), (4, 5)], [0.2, 0.9, 0.4]),     # score pick
    ([(1, 1), (2, 3), (2, 3)], [0.3, 0.3, 0.3]),     # majority, ties
])
def test_tta_vote_matches_jax(keys, scores):
    from tilawa_tpu.pipeline.predict import Recognizer as JaxRecognizer
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    def preds():
        return [{"surah": s, "ayah": a, "ayah_end": a, "score": sc, "i": i}
                for i, ((s, a), sc) in enumerate(zip(keys, scores))]

    assert Recognizer.tta_vote(preds()) == JaxRecognizer.tta_vote(preds())


def _port_modules():
    pkg = REPO / "tilawa_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke) leaves JAX,
    flax, msgpack and the JAX package out of sys.modules. Run without
    JAX_PLATFORMS=cpu: tilawa_tpu/__init__.py imports jax when it is set."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}: importlib.import_module(m)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax():
    """No import of the forbidden packages anywhere in the port's sources,
    lazy imports inside functions included."""
    files = list((REPO / "tilawa_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                assert words[1].split(".")[0] not in FORBIDDEN, f"{path}: {line}"


def test_default_device_needs_cuda(monkeypatch):
    from tilawa_tpu_torch.device import resolve_device
    from tilawa_tpu_torch.eval.experiments import load_champion

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_champion()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_on_cpu(capsys):
    from tilawa_tpu_torch.cli import recognize_main

    assert recognize_main(["--device", "cpu", "--no-tta", str(CORPUS / CLIPS[0])]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["surah"], out["ayah"], out["ayah_end"]) == (1, 1, 1)
