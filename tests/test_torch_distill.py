"""One distillation step of the port against tilawa_tpu's make_distill_step,
tiny f32 config, dropout 0, on the CPU.

Tolerances: loss, KL and CTC rel ≤ 1e-5; each gradient leaf max|Δ| ≤
1e-4 of its own max|g_jax|, or of the whole gradient's largest for leaves
under 1e-3 of it (tests/test_torch_train.assert_grads_match)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_train import assert_grads_match

from tilawa_tpu.models import fastconformer as jfc
from tilawa_tpu.train import distill as jdistill
from tilawa_tpu.train.train import TrainState as JaxTrainState
from tilawa_tpu_torch.models import fastconformer as tfc
from tilawa_tpu_torch.models.convert import load_into, params_from_jax
from tilawa_tpu_torch.train import distill as tdistill
from tilawa_tpu_torch.train.train import TrainState

TINY = dict(vocab_size=32, n_mels=16, d_model=32, num_layers=2, num_heads=2, ff_expansion=2,
            conv_kernel=5, subsampling_channels=16, dropout=0.0)


def _batch():
    rng = np.random.default_rng(0)
    n = 16000
    audio = rng.normal(scale=0.1, size=(2, n)).astype(np.float32)
    audio_lens = np.array([16000, 14000], np.int32)
    crop_start = np.array([2560, 0], np.int32)          # multiples of the 1280-sample stride
    crop_len = np.array([10000, 14000], np.int32)
    tokens = np.array([[3, 4, 4, 0], [5, 6, 7, 8]], np.int32)
    token_lens = np.array([3, 4], np.int32)
    return audio, audio_lens, crop_start, crop_len, tokens, token_lens


def _record_grads():
    """An optax transformation that applies nothing and keeps the gradient
    as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, _s, _p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


class _KeepGrads:
    def zero_grad(self):
        pass

    def step(self):
        pass


@pytest.mark.parametrize("pool", [0, 1])
def test_distill_step_matches_jax(pool):
    jcfg = jfc.FastConformerConfig(**TINY, dtype=jnp.float32, use_pallas=False)
    model = jfc.FastConformerCTC(jcfg)
    init = lambda k: jax.tree_util.tree_map(np.asarray, model.init(  # noqa: E731
        jax.random.PRNGKey(k), jnp.zeros((1, 8000)), jnp.array([8000])))
    s_vars, t_vars = init(0), init(1)
    tx = _record_grads()
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=s_vars["params"],
                          batch_stats=s_vars["batch_stats"], opt_state=tx.init(s_vars["params"]))
    batch = _batch()
    step = jax.jit(jdistill.make_distill_step(model, model, tx, jcfg.blank_id, teacher_pool=pool))
    new_state, (loss, kl, ctc) = step(state, t_vars, tuple(map(jnp.asarray, batch)),
                                      jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state)

    tcfg = tfc.FastConformerConfig(**TINY, use_pallas=False)
    student = load_into(tfc.FastConformerCTC(tcfg), s_vars)
    teacher = load_into(tfc.FastConformerCTC(tcfg), t_vars).requires_grad_(False)
    ours = tdistill.make_distill_step(teacher, tcfg.blank_id, teacher_pool=pool)(
        TrainState(student, _KeepGrads()), batch, torch.Generator().manual_seed(0))
    for o, r in zip(ours, (loss, kl, ctc)):
        assert abs(float(o) - float(r)) <= 1e-5 * abs(float(r))
    assert float(kl) > 0
    ref = params_from_jax({"params": grads})
    params = dict(student.named_parameters())
    assert_grads_match(ref, params)


def test_slice_to_front_and_pool_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 11, 5)).astype(np.float32)
    start, length = np.array([0, 4, 9], np.int32), np.array([11, 5, 7], np.int32)
    ref = np.asarray(jdistill._slice_to_front(jnp.asarray(x), jnp.asarray(start),
                                              jnp.asarray(length)))
    ours = tdistill._slice_to_front(torch.from_numpy(x), torch.from_numpy(start),
                                    torch.from_numpy(length)).numpy()
    assert np.array_equal(ours, ref)
    lp = np.log(rng.dirichlet(np.ones(5), size=(2, 9))).astype(np.float32)
    ref = np.asarray(jdistill._pool_teacher_time(jnp.asarray(lp), 2))
    ours = tdistill._pool_teacher_time(torch.from_numpy(lp), 2).numpy()
    assert np.max(np.abs(ours - ref)) <= 1e-5
