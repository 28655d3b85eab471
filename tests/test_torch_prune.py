"""The port's depth pruning (train/prune.py) against the JAX package's, on
the CPU.

* layer_indices: equal for every (total ≤ 17, keep, mode).
* prune_layers on champion-int4's tree: every leaf bitwise equal to JAX's
  (packed int4 and scales included) and an equal config, for the six
  pruned-ctc variants.
* a pruned small config (f32): the port's forward within 1e-4 of JAX's
  pruned flax forward (the tolerance of test_torch_model.py).
* the L6 first_n champion prune on one short v1 clip: collapsed greedy ids
  equal to JAX's.
* prune_checkpoint: each package reads the other's pruned checkpoint, leaf
  for leaf as its own.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.train import prune as jprune  # noqa: E402
from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables  # noqa: E402
from tilawa_tpu_torch.io.bundle import EXPORTS_DIR, load_variables  # noqa: E402
from tilawa_tpu_torch.train import prune as tprune  # noqa: E402

CHAMPION = EXPORTS_DIR / "champion-int4"
CORPUS = EXPORTS_DIR.parent / "benchmark" / "test_corpus"
VARIANTS = [(keep, mode) for keep in (12, 8, 6) for mode in ("first_n", "evenly_spaced")]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _config_dict(cfg) -> dict:
    """Every config field, the dtype by name (what config.json holds)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = str(out["dtype"]).removeprefix("torch.") if isinstance(
        out["dtype"], torch.dtype) else jnp.dtype(out["dtype"]).name
    return out


@pytest.mark.parametrize("mode", ["first_n", "evenly_spaced"])
def test_layer_indices_match_jax(mode):
    for total in range(1, 18):
        for keep in range(1, total + 2):
            assert tprune.layer_indices(total, keep, mode) == \
                jprune.layer_indices(total, keep, mode), (total, keep)
    with pytest.raises(ValueError):
        tprune.layer_indices(4, 2, "bogus")


@pytest.fixture(scope="module")
def champion_trees():
    return load_variables(CHAMPION), jax_load_variables(CHAMPION)


@pytest.mark.parametrize("keep,mode", VARIANTS)
def test_prune_champion_tree_bitwise_equal_to_jax(champion_trees, keep, mode):
    (cfg, variables), (jcfg, jvariables) = champion_trees
    new_cfg, new_vars = tprune.prune_layers(cfg, variables, keep, mode)
    ref_cfg, ref_vars = jprune.prune_layers(jcfg, jvariables, keep, mode)
    assert _config_dict(new_cfg) == _config_dict(ref_cfg)
    assert new_cfg.num_layers == keep
    ours, ref = dict(_leaves(new_vars)), dict(_leaves(ref_vars))
    assert sorted(ours) == sorted(ref)
    sliced = 0
    for path, leaf in ours.items():
        want = np.asarray(ref[path])
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, path
        assert leaf.tobytes() == want.tobytes(), path
        sliced += "blocks" in path and leaf.shape[0] == keep
    assert sliced > 0
    packed = ours[("params", "blocks", "block", "ff1", "lin1", "packed")]
    assert packed.dtype == np.uint8 and packed.shape[0] == keep


def test_prune_rejects_unscanned_config(champion_trees):
    cfg, variables = champion_trees[0]
    with pytest.raises(ValueError):
        tprune.prune_layers(dataclasses.replace(cfg, scan_layers=False), variables, 6)


@pytest.mark.parametrize("mode", ["first_n", "evenly_spaced"])
def test_pruned_small_forward_matches_jax(mode):
    from tilawa_tpu.models import fastconformer as jfc
    from tilawa_tpu_torch.models import fastconformer as tfc
    from tilawa_tpu_torch.models.convert import load_into

    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lengths = np.array([16000, 11200], np.int32)
    jcfg = jfc.FastConformerConfig.small(num_layers=4, dropout=0.0, use_pallas=False)
    variables = jax.tree_util.tree_map(np.asarray, jfc.FastConformerCTC(jcfg).init(
        jax.random.PRNGKey(3), jnp.asarray(audio), jnp.asarray(lengths)))
    jcfg2, jvars2 = jprune.prune_layers(jcfg, variables, 2, mode)
    ref, ref_lens = jfc.FastConformerCTC(jcfg2).apply(jvars2, jnp.asarray(audio),
                                                      jnp.asarray(lengths))

    cfg2, vars2 = tprune.prune_layers(
        tfc.FastConformerConfig.small(num_layers=4, dropout=0.0), variables, 2, mode)
    model = load_into(tfc.FastConformerCTC(cfg2), vars2).eval()
    assert len(model.blocks) == 2
    with torch.no_grad():
        ours, lens = model(torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    for b, t in enumerate(np.asarray(ref_lens)):
        np.testing.assert_allclose(ours.numpy()[b, :t], np.asarray(ref)[b, :t], atol=1e-4)


def test_pruned_l6_champion_ids_match_jax(champion_trees):
    from tilawa_tpu.data.audio import load_audio
    from tilawa_tpu.ops.ctc import collapse_ctc
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime

    (cfg, variables), (jcfg, jvariables) = champion_trees
    jcfg6, jvars6 = jprune.prune_layers(jcfg, jvariables, 6, "first_n")
    cfg6, vars6 = tprune.prune_layers(cfg, variables, 6, "first_n")
    audio = load_audio(CORPUS / "retasy_000.wav")
    _lp, ref_ids, ref_t = JaxRuntime(dataclasses.replace(jcfg6, use_pallas=False),
                                     jvars6).forward(audio)
    rt = EncoderRuntime(cfg6, vars6, device="cpu")
    assert len(rt.model.blocks) == 6
    _lp, ids, t = rt.forward(audio)
    assert t == ref_t
    assert collapse_ctc(ids, rt.blank_id) == collapse_ctc(np.asarray(ref_ids)[:ref_t], 1024)


def test_prune_checkpoint_round_trips(tmp_path):
    ours = tprune.prune_checkpoint(str(CHAMPION), str(tmp_path / "port"), 8, "first_n")
    ref = jprune.prune_checkpoint(str(CHAMPION), str(tmp_path / "jax"), 8, "first_n")
    assert json.loads((ours / "config.json").read_text()) == \
        json.loads((ref / "config.json").read_text())
    # each package reads the other's checkpoint
    jcfg, jvars = jax_load_variables(ours)
    cfg, variables = load_variables(ref)
    assert jcfg.num_layers == cfg.num_layers == 8
    for theirs, mine in ((variables, jax_load_variables(ref)[1]), (jvars, load_variables(ours)[1])):
        a, b = dict(_leaves(theirs)), dict(_leaves(mine))
        assert sorted(a) == sorted(b)
        for path, leaf in a.items():
            assert np.asarray(leaf).tobytes() == np.asarray(b[path]).tobytes(), path
