"""Checkpoints and export bundles between the port and the JAX package.

Tolerances: forwards of a checkpoint written by one package and read by
the other, f32 small config, max|Δ log-prob| ≤ 1e-4 (the bound
tests/test_torch_model.py holds the port's f32 forward to; 1.05e-5 seen
here); bundle bytes and digests: equality."""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from tilawa_tpu.models import fastconformer as jfc
from tilawa_tpu.train import checkpoint as jckpt
from tilawa_tpu.train import export as jexport
from tilawa_tpu_torch.io import bundle
from tilawa_tpu_torch.models import fastconformer as tfc
from tilawa_tpu_torch.models.convert import load_into, variables_from_torch
from tilawa_tpu_torch.train import checkpoint as tckpt
from tilawa_tpu_torch.train import export as texport
from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config
from tilawa_tpu_torch.train.train import init_state

CHAMPION = Path(__file__).resolve().parent.parent / "exports" / "champion-int4"


def _audio():
    rng = np.random.default_rng(0)
    return rng.normal(scale=0.1, size=(2, 12000)).astype(np.float32), np.array([12000, 9000],
                                                                              np.int32)


def _jax_forward(path, audio, lens):
    cfg, variables = jckpt.load_variables(path)
    lp, _ = jfc.FastConformerCTC(cfg).apply(variables, jnp.asarray(audio), jnp.asarray(lens))
    return np.asarray(lp)


def _torch_forward(path, audio, lens):
    cfg, variables = tckpt.load_variables(path)
    model = load_into(tfc.FastConformerCTC(cfg), variables)
    with torch.no_grad():
        lp, _ = model(torch.from_numpy(audio), torch.from_numpy(lens))
    return lp.numpy()


def test_checkpoints_cross_read(tmp_path):
    audio, lens = _audio()
    # the port writes, JAX reads
    cfg = tfc.FastConformerConfig.small(use_pallas=False)
    model = init_state(cfg, seed=1, device="cpu")
    tckpt.save_variables(tmp_path / "port", cfg, variables_from_torch(model))
    jcfg = jckpt.load_config(tmp_path / "port")
    assert jcfg == jfc.FastConformerConfig.small(use_pallas=False)
    a, b = _jax_forward(tmp_path / "port", audio, lens), _torch_forward(tmp_path / "port",
                                                                        audio, lens)
    assert np.max(np.abs(a - b)) <= 1e-4
    # JAX writes, the port reads
    jm = jfc.FastConformerCTC(jcfg)
    jvars = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8000)), jnp.array([8000]))
    jckpt.save_variables(tmp_path / "jax", jcfg, jvars)
    assert tckpt.load_config(tmp_path / "jax") == cfg
    a, b = _jax_forward(tmp_path / "jax", audio, lens), _torch_forward(tmp_path / "jax",
                                                                       audio, lens)
    assert np.max(np.abs(a - b)) <= 1e-4
    # and the port's writer gives back the file it read, byte for byte
    raw = (tmp_path / "jax" / "variables.msgpack").read_bytes()
    assert bundle.packb(bundle.unpackb(raw)) == raw


@pytest.fixture(scope="module")
def zero_step_export(tmp_path_factory):
    """The dequantized champion as a training run writes it (into the model,
    back out of its state dict), then exported to int4 by both packages."""
    root = tmp_path_factory.mktemp("export")
    cfg, variables = bundle.load_variables(CHAMPION)
    fp_cfg = dequantized_config(cfg)
    model = load_into(tfc.FastConformerCTC(fp_cfg), dequantize_variables(variables))
    tckpt.save_variables(root / "ckpt", fp_cfg, variables_from_torch(model))
    del model
    texport.export_bundle(root / "ckpt", root / "port", quant="int4")
    jexport.export_bundle(root / "ckpt", root / "jax", quant="int4")
    return root


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_zero_step_export_is_the_champion(zero_step_export):
    out = zero_step_export / "port"
    assert _sha(out / "variables.msgpack") == _sha(CHAMPION / "variables.msgpack")
    assert all(texport.verify_bundle(out).values())
    assert all(jexport.verify_bundle(out).values())


def test_export_metadata_equals_jax(zero_step_export):
    """Key for key except exported_at. The JAX package writes the same
    tree in its init template's key order, so its variables.msgpack has
    the same length and leaves but other bytes (and another sha256)."""
    port = json.loads((zero_step_export / "port" / "export_metadata.json").read_text())
    ref = json.loads((zero_step_export / "jax" / "export_metadata.json").read_text())
    port.pop("exported_at"), ref.pop("exported_at")
    port_v, ref_v = port["files"].pop("variables.msgpack"), ref["files"].pop("variables.msgpack")
    assert port == ref
    assert port_v["bytes"] == ref_v["bytes"]
    a = bundle.read_variables(zero_step_export / "port")
    b = bundle.read_variables(zero_step_export / "jax")

    def leaves(t, p=()):
        for k, v in t.items():
            yield from leaves(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)]

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    assert all(np.array_equal(la[k], lb[k]) for k in la)


def test_server_accepts_the_bundle(zero_step_export, monkeypatch):
    from tilawa_tpu_torch.streaming.server import ModelLoader

    monkeypatch.setenv("TILAWA_CHECKPOINT", str(zero_step_export / "port"))
    loader = ModelLoader(warmup=False, device="cpu")
    loader._load()
    assert loader.state["phase"] == "ready", loader.state
    # negative control: a digest that does not match is refused
    bad = zero_step_export / "bad"
    bad.mkdir()
    for name in ("config.json", "variables.msgpack"):
        (bad / name).symlink_to(zero_step_export / "port" / name)
    meta = json.loads((zero_step_export / "port" / "export_metadata.json").read_text())
    meta["files"]["variables.msgpack"]["sha256"] = "0" * 64
    (bad / "export_metadata.json").write_text(json.dumps(meta))
    monkeypatch.setenv("TILAWA_CHECKPOINT", str(bad))
    loader = ModelLoader(warmup=False, device="cpu")
    loader._load()
    assert loader.state["phase"] == "error" and "sha256" in loader.state["error"]
    assert not texport.verify_bundle(bad)["variables.msgpack"]


def test_export_cli_verifies(zero_step_export, capsys):
    assert texport.main(["--checkpoint", str(zero_step_export / "port"), "--verify"]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "config.json": True, "variables.msgpack": True, "tokenizer.model": True,
        "vocab.json": True}


def test_training_entry_points_run_on_the_cpu(tmp_path):
    """The training CLIs with --device cpu on a small int4 bundle: export
    (fp → int4), finetune from it, export the fine-tuned checkpoint and
    verify it, distill (int4 teacher, dequantized student), fit_report."""
    import subprocess
    import sys

    repo = Path(__file__).resolve().parent.parent
    cfg = tfc.FastConformerConfig.small(dtype=torch.bfloat16)
    tckpt.save_variables(tmp_path / "fp", cfg, variables_from_torch(init_state(cfg, 2, "cpu")))

    def run(module, *args):
        out = subprocess.run([sys.executable, "-m", f"tilawa_tpu_torch.train.{module}", *args],
                             cwd=repo, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout

    run("export", "--checkpoint", str(tmp_path / "fp"), "--out", str(tmp_path / "small-int4"))
    assert tckpt.load_config(tmp_path / "small-int4").quant == "int4"
    out = run("finetune", "--device", "cpu", "--init", str(tmp_path / "small-int4"),
              "--corpora", "v1", "--steps", "2", "--checkpoint-dir", str(tmp_path / "ft"))
    assert "step     1" in out
    run("export", "--checkpoint", str(tmp_path / "ft" / "step_000002"),
        "--out", str(tmp_path / "ft-int4"))
    assert all(texport.verify_bundle(tmp_path / "ft-int4").values())
    out = run("distill", "--device", "cpu", "--student-init", str(tmp_path / "small-int4"),
              "--teacher", str(tmp_path / "small-int4"), "--corpora", "v1", "--steps", "1",
              "--checkpoint-dir", str(tmp_path / "distill"))
    assert "kl" in out and (tmp_path / "distill" / "step_000001" / "variables.msgpack").exists()
    out = run("fit_report", "--device", "cpu", "--checkpoint", str(tmp_path / "ft-int4"),
              "--corpora", "v1", "--worst", "3")
    assert "clips  mean loss" in out
