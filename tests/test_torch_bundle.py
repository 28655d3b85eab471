"""The port's msgpack bundle reader and weight converter vs flax."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from flax import serialization  # noqa: E402

from tilawa_tpu_torch.io import bundle  # noqa: E402
from tilawa_tpu_torch.models.convert import load_into, params_from_jax  # noqa: E402
from tilawa_tpu_torch.models.fastconformer import (  # noqa: E402
    FastConformerConfig,
    FastConformerCTC,
)

EXPORTS = bundle.EXPORTS_DIR


def _flat(tree):
    return {
        jax.tree_util.keystr(path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


@pytest.mark.parametrize("name", ["champion-int4", "stream6-int8"])
def test_reader_matches_flax(name):
    raw = (EXPORTS / name / "variables.msgpack").read_bytes()
    ref = _flat(serialization.msgpack_restore(raw))
    ours = _flat(bundle.unpackb(raw))
    assert ours.keys() == ref.keys()
    for key, leaf in ref.items():
        leaf = np.asarray(leaf)
        assert ours[key].dtype == leaf.dtype, key
        assert ours[key].shape == leaf.shape, key
        np.testing.assert_array_equal(ours[key], leaf, err_msg=key)


def test_reader_scalars_and_containers():
    doc = {"a": [1, -3, 300, -70000, 2**40, 1.5, True, None, "x" * 40],
           "b": {"nested": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    out = bundle.unpackb(serialization.msgpack_serialize(doc))
    assert out["a"] == doc["a"]
    np.testing.assert_array_equal(out["b"]["nested"], doc["b"]["nested"])


def test_reader_rejects_other_dtypes_and_trailing_bytes():
    with pytest.raises(bundle.MsgpackError, match="float64"):
        bundle.unpackb(serialization.msgpack_serialize({"w": np.zeros(3, np.float64)}))
    good = serialization.msgpack_serialize({"w": np.zeros(3, np.float32)})
    with pytest.raises(bundle.MsgpackError, match="trailing"):
        bundle.unpackb(good + b"\x00")


def test_config_from_json_matches_bundle():
    cfg = FastConformerConfig.from_json(EXPORTS / "champion-int4" / "config.json")
    raw = json.loads((EXPORTS / "champion-int4" / "config.json").read_text())
    assert cfg.dtype == torch.bfloat16 and cfg.quant == "int4"
    for key in ("vocab_size", "d_model", "num_layers", "num_heads", "conv_kernel"):
        assert getattr(cfg, key) == raw[key]


def test_shipped_checkpoint_is_champion(monkeypatch):
    monkeypatch.delenv("TILAWA_CHECKPOINT", raising=False)
    assert bundle.shipped_checkpoint() == EXPORTS / "champion-int4"


def test_params_from_jax_maps_every_leaf():
    cfg, variables = bundle.load_variables(EXPORTS / "champion-int4")
    sd = params_from_jax(variables)
    leaves = _flat(variables)
    n_expected = sum(
        cfg.num_layers if "'blocks'" in key else 1 for key in leaves
    )
    assert len(sd) == n_expected
    model = FastConformerCTC(cfg)
    assert set(model.state_dict()) == set(sd)
    load_into(model, variables)   # strict: no leaf left over, no buffer unset

    # scan axis unstacked, conv kernels HWIO → OIHW / WIO → OIW, int4 kept
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["blocks.16.ff1.lin1.packed"].numpy(), p["blocks"]["block"]["ff1"]["lin1"]["packed"][16])
    np.testing.assert_array_equal(
        sd["subsampling.conv_in.kernel"].numpy(),
        p["subsampling"]["conv_in"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["blocks.3.conv.dw.kernel"].numpy(),
        p["blocks"]["block"]["conv"]["dw"]["kernel"][3].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        sd["blocks.5.conv.bn.var"].numpy(),
        variables["batch_stats"]["blocks"]["block"]["conv"]["bn"]["var"][5])


def test_params_from_jax_rejects_leftovers():
    cfg = FastConformerConfig.small()
    _, variables = bundle.load_variables(EXPORTS / "champion-int4")
    with pytest.raises(ValueError, match="collections"):
        params_from_jax({**variables, "cache": {}})
    with pytest.raises(RuntimeError):   # champion leaves do not fit the small model
        load_into(FastConformerCTC(cfg), variables)
