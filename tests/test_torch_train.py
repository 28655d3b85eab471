"""The port's training path against the JAX package, run live on the CPU.

Tolerances (f32 compute everywhere here):
  * one training step (loss and gradients, live and frozen BatchNorm,
    dropout 0, no SpecAugment): loss rel ≤ 1e-5; each gradient leaf whose
    max|g_jax| is at least GRAD_FLOOR (1e-3) of the whole gradient's largest
    is held to max|Δ| ≤ 1e-4 of its own max|g_jax| (the same f32 math, sums
    in other orders; the CTC gradient is the port's reverse pass through
    optax's recursion, ops/ctc.py ctc_loss, against JAX's autodiff of it);
    a leaf below the floor to 1e-4 of the whole
    gradient's largest: those are the leaves whose gradient is zero in
    exact arithmetic (the key bias, under the softmax's shift invariance;
    the depthwise conv bias under batch-statistics BatchNorm) and hold only
    rounding noise, ~1e-8, in both packages. The subsampling's first conv,
    the one layer fed the raw log-mels (not normalized, so its gradient sums
    B·T·F products that cancel), is held to 2e-3 of its own max|g_jax|: on
    the champion cut JAX's own f32 gradient of its bias is 1.2e-3 of its
    max from the same gradient in f64, the port's 3.9e-4. The new BatchNorm
    running stats max|Δ| ≤ 1e-6;
  * the optimizer fed optax's gradient sequence: params rel ≤ 1e-6 (optax
    runs its schedule and Adam in f32, the port's lr is a float64);
  * the schedule within 1e-5·|optax| + 1e-7·lr: optax evaluates it in f32,
    a few ulps off the exact value (2.1e-6 rel seen in the warmup; near the
    end of the cosine, 1 + cos cancels, leaving a few f32 ulps of the peak);
    0 at step 0 exactly; the global-norm clip rel ≤ 1e-6;
  * ctc_loss_fn rel ≤ 1e-5 of optax's, feasible rows and infeasible ones.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from tilawa_tpu.models import fastconformer as jfc
from tilawa_tpu.train import train as jtrain
from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
from tilawa_tpu.train.quantize import dequantize_variables as jax_dequantize
from tilawa_tpu_torch.models import fastconformer as tfc
from tilawa_tpu_torch.models.convert import load_into, params_from_jax
from tilawa_tpu_torch.ops import frontend, quant
from tilawa_tpu_torch.ops.specaug import spec_augment
from tilawa_tpu_torch.train import train as ttrain
from tilawa_tpu_torch.train.data import synthetic_batches

REPO = Path(__file__).resolve().parent.parent
EXPORTS = REPO / "exports"
# the tiny config of tests/test_train_step.py, dropout 0 and no SpecAugment
TINY = dict(vocab_size=32, n_mels=16, d_model=32, num_layers=2, num_heads=2, ff_expansion=2,
            conv_kernel=5, subsampling_channels=16, dropout=0.0)


def _tiny_batch():
    return (
        np.random.default_rng(0).normal(scale=0.1, size=(2, 8000)).astype(np.float32),
        np.array([8000, 6000], np.int32),
        np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32),
        np.array([3, 2], np.int32),
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tiny_variables():
    jcfg = jfc.FastConformerConfig(**TINY, dtype=jnp.float32, use_pallas=False)
    variables = _np(jfc.FastConformerCTC(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8000)), jnp.array([8000])))
    # running stats away from (0, 1), so that frozen BatchNorm is not the identity
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a is not None else a).astype(np.float32),
        variables["batch_stats"])
    return jcfg, tfc.FastConformerConfig(**TINY, use_pallas=False), variables


def _champion_cut_variables():
    """The dequantized champion cut to its first 2 blocks, f32 compute."""
    _cfg, variables = jax_load_variables(EXPORTS / "champion-int4")
    variables = _np(jax_dequantize(variables))
    for col in ("params", "batch_stats"):
        variables[col]["blocks"] = jax.tree_util.tree_map(lambda a: a[:2], variables[col]["blocks"])
    kw = dict(num_layers=2, dropout=0.0, use_pallas=False)
    return (jfc.FastConformerConfig(**kw), tfc.FastConformerConfig(**kw), variables)


def _champion_batch():
    from tilawa_tpu_torch.train.data import load_corpus_examples, pad_batch

    ex = {cid: (a, ids) for cid, a, ids in load_corpus_examples("v1", return_ids=True)}
    chunk = [ex["retasy_008"], ex["retasy_014"]]
    return pad_batch(chunk, max(len(a) for a, _ in chunk), 16)


def _jax_step(jcfg, variables, batch, freeze_bn):
    """Loss, gradients and new batch_stats of tilawa_tpu train.py:80-110's
    loss_fn under jax.value_and_grad."""
    model = jfc.FastConformerCTC(jcfg)
    audio, lens, tokens, tlens = (jnp.asarray(b) for b in batch)
    bs = variables["batch_stats"]
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        v = {"params": params, "batch_stats": bs}
        if freeze_bn:
            lp, el = model.apply(v, audio, lens, deterministic=False, use_running_average=True,
                                 rngs={"dropout": key})
            return jtrain.ctc_loss_fn(lp, el, tokens, tlens, jcfg.blank_id), bs
        (lp, el), upd = model.apply(v, audio, lens, deterministic=False,
                                    use_running_average=False, mutable=["batch_stats"],
                                    rngs={"dropout": key})
        return jtrain.ctc_loss_fn(lp, el, tokens, tlens, jcfg.blank_id), upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return float(loss), _np(grads), _np(new_bs)


def _torch_step(tcfg, variables, batch, freeze_bn):
    model = load_into(tfc.FastConformerCTC(tcfg), variables)
    audio, lens, tokens, tlens = batch
    lp, _ = model(torch.from_numpy(audio), torch.from_numpy(lens), deterministic=False,
                  use_running_average=freeze_bn, generator=torch.Generator().manual_seed(0))
    loss = ttrain.ctc_loss_fn(lp, ttrain.encoder_lengths(lens), tokens, tlens, tcfg.blank_id)
    loss.backward()
    return model, float(loss.detach())


GRAD_FLOOR = 1e-3
GRAD_RTOL = 1e-4
# the layer fed the raw log-mels: its f32 gradient cancels (module docstring)
LEAF_RTOL = {"subsampling.conv_in.kernel": 2e-3, "subsampling.conv_in.bias": 2e-3}


def assert_grads_match(ref: dict, params: dict) -> None:
    """Each leaf's gradient against JAX's: to GRAD_RTOL (LEAF_RTOL where it
    names the leaf) of its own max|g| where that is at least GRAD_FLOOR of
    the whole gradient's largest, else (leaves that are zero in exact
    arithmetic) to GRAD_RTOL of the largest."""
    top = max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        ours = params[name].grad
        assert ours is not None and ours.shape == g.shape, name
        own = float(g.abs().max())
        bound = LEAF_RTOL.get(name, GRAD_RTOL) * own if own >= GRAD_FLOOR * top else GRAD_RTOL * top
        assert float((ours - g).abs().max()) <= bound, (name, own / top)


@pytest.mark.parametrize("which", ["tiny", "champion-2-blocks"])
@pytest.mark.parametrize("freeze_bn", [False, True], ids=["live-bn", "frozen-bn"])
def test_one_step_matches_jax(which, freeze_bn):
    if which == "tiny":
        jcfg, tcfg, variables = _tiny_variables()
        batch = _tiny_batch()
    else:
        jcfg, tcfg, variables = _champion_cut_variables()
        batch = _champion_batch()
    loss_j, grads_j, bs_j = _jax_step(jcfg, variables, batch, freeze_bn)
    model, loss_t = _torch_step(tcfg, variables, batch, freeze_bn)

    assert np.isfinite(loss_j) and abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    ref = params_from_jax({"params": grads_j})
    params = dict(model.named_parameters())
    assert ref.keys() == params.keys()
    assert_grads_match(ref, params)
    new_bs = params_from_jax({"batch_stats": bs_j})
    buffers = dict(model.named_buffers())
    for name, ref_stat in new_bs.items():
        assert float((buffers[name] - ref_stat).abs().max()) <= 1e-6, name
    if freeze_bn:   # frozen: the stats are the ones loaded
        old = params_from_jax({"batch_stats": variables["batch_stats"]})
        assert all(torch.equal(buffers[n], old[n]) for n in old)


def test_config_json_round_trip(tmp_path):
    from tilawa_tpu.train.checkpoint import load_config as jax_load_config
    from tilawa_tpu.train.checkpoint import save_variables as jax_save
    from tilawa_tpu_torch.train.checkpoint import load_config, save_variables

    cases = [
        (jfc.FastConformerConfig.large(quant="int4", dropout=0.0),
         tfc.FastConformerConfig.large(quant="int4", dropout=0.0)),
        (jfc.FastConformerConfig.small(sa_freq_masks=2, sa_time_masks=10, remat=True),
         tfc.FastConformerConfig.small(sa_freq_masks=2, sa_time_masks=10, remat=True)),
        (jfc.FastConformerConfig(**TINY, dtype=jnp.float32, use_pallas=False),
         tfc.FastConformerConfig(**TINY, use_pallas=False)),
    ]
    for i, (jcfg, tcfg) in enumerate(cases):
        jax_save(tmp_path / f"j{i}", jcfg, {"params": {}})
        save_variables(tmp_path / f"t{i}", tcfg, {"params": {}})
        assert (tmp_path / f"j{i}" / "config.json").read_text() == \
            (tmp_path / f"t{i}" / "config.json").read_text()
        assert load_config(tmp_path / f"j{i}") == tcfg
        assert jax_load_config(tmp_path / f"t{i}") == jcfg


@pytest.mark.parametrize("lr,warmup,total", [
    (3e-4, 100, 10_000), (3e-5, 100, 6), (1e-3, 5, 40), (3e-5, 200, 2000), (0.5, 1, 2)])
def test_schedule_matches_optax(lr, warmup, total):
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1))
    ours = ttrain.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1))
    assert ours(0) == 0.0
    for count in sorted({*range(0, 12), *range(0, total + 5, max(1, total // 37)),
                         warmup - 1, warmup, warmup + 1, total - 1, total, total + 3}):
        if count < 0:
            continue
        r = float(ref(count))
        assert abs(ours(count) - r) <= 1e-5 * abs(r) + 1e-7 * lr, count


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((5, 7), (3,), (2, 2, 4))]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttrain.clip_by_global_norm(ours, 1.0)
    assert (float(norm) >= 1.0) == (scale > 1)
    for o, r, g in zip(ours, ref, grads):
        r = np.asarray(r)
        assert np.max(np.abs(o.numpy() - r)) <= 1e-6 * np.max(np.abs(r))
        if scale < 1:
            assert np.array_equal(o.numpy(), g)


def test_optimizer_matches_optax():
    rng = np.random.default_rng(4)
    shapes = ((6, 4), (4,), (3, 3, 2))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (0.05 if k % 2 else 3.0)
              for s in shapes] for k in range(5)]
    tx = jtrain.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=5)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ttrain.make_optimizer(tp, lr=1e-2, warmup_steps=2, total_steps=5)
    for k, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for p, r in zip(tp, jp):
            r = np.asarray(r)
            assert np.max(np.abs(p.detach().numpy() - r)) <= 1e-6 * np.max(np.abs(r)), k
        if k == 0:   # lr 0 at the first update: nothing moves
            assert all(np.array_equal(p.detach().numpy(), x) for p, x in zip(tp, params))


def test_ctc_loss_matches_optax_on_feasible_batches():
    rng = np.random.default_rng(5)
    b, t, v = 4, 30, 12
    lp = jax.nn.log_softmax(jnp.asarray(rng.standard_normal((b, t, v)).astype(np.float32)))
    enc = np.array([30, 25, 18, 9], np.int32)
    tokens = np.array([[1, 2, 2, 3, 0], [4, 4, 4, 0, 0], [5, 6, 7, 8, 9], [1, 0, 0, 0, 0]],
                      np.int32)
    tlens = np.array([4, 3, 5, 1], np.int32)
    ref = float(jtrain.ctc_loss_fn(lp, jnp.asarray(enc), jnp.asarray(tokens),
                                   jnp.asarray(tlens), v - 1))
    ours = float(ttrain.ctc_loss_fn(torch.from_numpy(np.array(lp)), enc, tokens, tlens, v - 1))
    assert abs(ours - ref) <= 1e-5 * abs(ref)


def test_ctc_loss_infeasible_crop_matches_optax():
    """random_window_crop can leave a crop with no spare frame (its labels
    need every encoder frame); the speed perturbation that follows in
    bucketed_corpus_batches (0.9x) then makes it infeasible. Recorded on v1
    (multi_036_001_005): PyTorch's CTC gives inf there, optax a large finite
    loss (log_epsilon -1e5), and ctc_loss_fn gives optax's."""
    from tilawa_tpu_torch.train.data import (
        _attach_spans, _augment, load_corpus_examples, random_window_crop)

    raw = [e for e in load_corpus_examples("v1", max_audio_s=160, return_ids=True)
           if e[0] == "multi_036_001_005"]
    (a, ids, spans), = _attach_spans(("v1",), raw)
    rng = np.random.default_rng(39)
    for _ in range(200):
        out, kept = random_window_crop(a, ids, spans, rng, max_len=len(a))
        out = _augment(out, rng, 10**9)
        kept = np.asarray(kept)
        need = len(kept) + int(np.sum(kept[1:] == kept[:-1]))
        t = int(ttrain.encoder_lengths([len(out)])[0])
        if t < need:
            break
    else:
        pytest.fail("no infeasible crop found")
    v = 1025
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        np.random.default_rng(6).standard_normal((2, 8, v)).astype(np.float32))))
    enc = np.array([8, t], np.int32)
    tokens = np.zeros((2, 16), np.int32)
    tokens[0, :3] = kept[:3]
    tokens[1, :len(kept)] = kept
    tlens = np.array([3, len(kept)], np.int32)
    ref = jtrain.ctc_loss_fn(jnp.asarray(lp), jnp.asarray(enc), jnp.asarray(tokens),
                             jnp.asarray(tlens), v - 1)
    ref_rows = np.asarray(optax.ctc_loss(
        jnp.asarray(lp), (jnp.arange(8)[None] >= jnp.asarray(enc)[:, None]).astype(jnp.float32),
        jnp.asarray(tokens), (jnp.arange(16)[None] >= jnp.asarray(tlens)[:, None]).astype(
            jnp.float32), blank_id=v - 1))
    plain = torch.nn.functional.ctc_loss(
        torch.from_numpy(lp).transpose(0, 1), torch.from_numpy(tokens).long(),
        torch.from_numpy(enc).long(), torch.from_numpy(tlens).long(), blank=v - 1,
        reduction="none")
    assert np.isfinite(float(plain[0])) and np.isinf(float(plain[1]))
    assert 1e4 < ref_rows[1] < 1e8
    rows = ttrain.ctc_losses(torch.from_numpy(lp), enc, tokens, tlens, v - 1).numpy()
    assert np.all(np.abs(rows - ref_rows) <= 1e-5 * np.abs(ref_rows))
    ours = ttrain.ctc_loss_fn(torch.from_numpy(lp), enc, tokens, tlens, v - 1)
    assert abs(float(ours) - float(ref)) <= 1e-5 * abs(float(ref))


def test_spec_augment_bounds_and_seed():
    b, t, f = 3, 200, 80
    feats = torch.randn(b, t, f) + 5.0          # no element is 0 before masking
    lengths = torch.tensor([200, 120, 37])
    kw = dict(freq_masks=2, freq_width=27, time_masks=10, time_frac=0.05)
    out = spec_augment(feats, lengths, torch.Generator().manual_seed(7), **kw)
    again = spec_augment(feats, lengths, torch.Generator().manual_seed(7), **kw)
    assert torch.equal(out, again)
    assert not torch.equal(out, spec_augment(feats, lengths, torch.Generator().manual_seed(8),
                                             **kw))
    assert torch.equal(spec_augment(feats, lengths, torch.Generator(), freq_masks=0,
                                    time_masks=0), feats)
    masked = out == 0
    for i, n in enumerate(lengths.tolist()):
        bands = masked[i].all(dim=0)                     # frequencies masked at every frame
        assert int(bands.sum()) <= 2 * 27
        rows = masked[i][:, ~bands].all(dim=1) if (~bands).any() else masked[i].all(dim=1)
        assert not rows[n:].any()                        # nothing past the valid length
        assert int(rows.sum()) <= 10 * (int(max(n * 0.05, 1.0)) + 1)
        assert torch.equal(out[i][~masked[i]], feats[i][~masked[i]])


def _tiny_torch_config(**kw):
    base = dict(TINY, dropout=0.1, sa_freq_masks=1, sa_time_masks=2, use_pallas=False)
    base.update(kw)
    return tfc.FastConformerConfig(**base)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_remat_recomputes_with_the_same_masks():
    """remat=True gives the same loss and gradients as remat=False for one
    generator state: a block's dropout masks are drawn before the block."""
    batch = _tiny_batch()
    grads = []
    for remat in (False, True):
        cfg = _tiny_torch_config(remat=remat)
        model = ttrain.init_params(tfc.FastConformerCTC(cfg), seed=3)
        lp, _ = model(torch.from_numpy(batch[0]), torch.from_numpy(batch[1]),
                      deterministic=False, use_running_average=False,
                      generator=torch.Generator().manual_seed(11))
        loss = ttrain.ctc_loss_fn(lp, ttrain.encoder_lengths(batch[1]), batch[2], batch[3],
                                  cfg.blank_id)
        loss.backward()
        grads.append((float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()},
                      {n: b.clone() for n, b in model.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = grads
    assert l0 == l1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(b0[n], b1[n]) for n in b0)


def test_dropout_needs_a_generator_and_deterministic_ignores_it():
    cfg = _tiny_torch_config()
    model = ttrain.init_params(tfc.FastConformerCTC(cfg), seed=3)
    audio, lens = torch.from_numpy(_tiny_batch()[0]), torch.from_numpy(_tiny_batch()[1])
    with pytest.raises(ValueError, match="Generator"):
        model(audio, lens, deterministic=False)
    with torch.no_grad():
        a, _ = model(audio, lens)
        b, _ = model(audio, lens, generator=torch.Generator().manual_seed(1))
        c, _ = model(audio, lens, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_freeze_bn_and_step_zero():
    """Step 0 runs at lr 0 and changes no parameter; frozen BatchNorm keeps
    its stats over steps that do change the parameters; live BatchNorm
    moves them."""
    cfg = _tiny_torch_config()
    for freeze in (True, False):
        model = ttrain.init_params(tfc.FastConformerCTC(cfg), seed=5)
        state = ttrain.TrainState(model, ttrain.make_optimizer(
            model.parameters(), lr=1e-3, warmup_steps=2, total_steps=4))
        step = ttrain.make_train_step(cfg.blank_id, freeze_bn=freeze)
        p0 = _params(model)
        bs0 = {n: b.clone() for n, b in model.named_buffers()}
        batches = synthetic_batches(2, 8000, vocab=32, token_len=4)
        loss = step(state, next(batches), ttrain.step_generator(0, 0, torch.device("cpu")))
        assert np.isfinite(float(loss))
        assert all(torch.equal(p, p0[n]) for n, p in model.named_parameters())
        for i in (1, 2):
            step(state, next(batches), ttrain.step_generator(0, i, torch.device("cpu")))
        assert state.step == 3
        assert any(not torch.equal(p, p0[n]) for n, p in model.named_parameters())
        bn = {n: b for n, b in model.named_buffers() if n.endswith((".mean", ".var"))}
        same = all(torch.equal(b, bs0[n]) for n, b in bn.items())
        assert same == freeze


def test_train_twice_is_bitwise_equal_on_cpu(tmp_path):
    cfg = _tiny_torch_config()
    runs = []
    for k in range(2):
        model, _state, hist = ttrain.train(
            cfg, synthetic_batches(2, 8000, vocab=32, token_len=4), 3, lr=1e-3, seed=2,
            log_every=1, warmup_steps=1, device="cpu", checkpoint_dir=tmp_path / str(k))
        runs.append((hist, _params(model)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])
    a = (tmp_path / "0" / "step_000003" / "variables.msgpack").read_bytes()
    assert a == (tmp_path / "1" / "step_000003" / "variables.msgpack").read_bytes()


def test_init_params_follow_flax_defaults():
    model = ttrain.init_params(tfc.FastConformerCTC(tfc.FastConformerConfig.small()), seed=0)
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            fan_in = p.shape[0] if p.dim() == 2 else int(np.prod(p.shape[1:]))
            std = 1.0 / np.sqrt(fan_in) / 0.87962566103423978
            assert float(p.abs().max()) <= 2 * std + 1e-6, name
            if p.numel() > 2000:
                assert abs(float(p.std()) - 1.0 / np.sqrt(fan_in)) < 0.1 / np.sqrt(fan_in), name
        elif name.endswith("scale"):
            assert torch.all(p == 1), name
        else:
            assert torch.all(p == 0), name


def test_quantized_config_cannot_train():
    cfg = tfc.FastConformerConfig.small(quant="int4")
    with pytest.raises(ValueError, match="quantized"):
        ttrain.init_state(cfg, device="cpu")
    model = tfc.FastConformerCTC(cfg)
    audio, lens = torch.zeros(1, 8000), torch.tensor([8000])
    with pytest.raises(ValueError, match="quantized"):
        model(audio, lens, deterministic=False, generator=torch.Generator())


def test_wrappers_raise_on_inputs_that_need_a_gradient():
    """The kernel wrappers are forward only: an input that requires a
    gradient under grad mode raises on every device (here the plain route
    of CPU tensors) instead of returning an output with no grad_fn."""
    rng = np.random.default_rng(8)
    packed, scales = (torch.from_numpy(a) for a in quant.pack_int4(
        rng.standard_normal((64, 16)).astype(np.float32)))
    q, s8 = (torch.from_numpy(a) for a in quant.quantize_int8(
        rng.standard_normal((64, 16)).astype(np.float32)))
    x = torch.randn(3, 64, requires_grad=True)
    tables = frontend.mel_tables()
    pre = torch.randn(1, 4000, requires_grad=True)
    calls = {
        "int4_matmul": lambda: quant.int4_matmul(x, packed, scales),
        "int4_dense": lambda: quant.int4_dense(x, packed, scales, None, torch.float32),
        "int8_matmul": lambda: quant.int8_matmul(x, q, s8),
        "int8_dense": lambda: quant.int8_dense(x, q, s8),
        "fused_log_mel": lambda: frontend.fused_log_mel(pre, tables),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="forward only"):
            call()
        with torch.no_grad():
            assert call().grad_fn is None, name
    bias = torch.zeros(16, requires_grad=True)
    with pytest.raises(RuntimeError, match=r"int4_dense computes forward only"):
        quant.int4_dense(x.detach(), packed, scales, bias)


def test_port_names_no_optax():
    """tilawa_tpu_torch and chip_smoke name none of jax, flax, optax,
    msgpack or tilawa_tpu in an import (the training and parallel modules
    included), and importing the training and parallel modules loads none
    of them."""
    forbidden = ("jax", "flax", "optax", "msgpack", "tilawa_tpu")
    for path in [*(REPO / "tilawa_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                assert words[1].split(".")[0] not in forbidden, f"{path}: {line}"
    modules = [f"tilawa_tpu_torch.train.{m}" for m in (
        "train", "finetune", "distill", "export", "fit_report", "align", "data", "checkpoint",
        "quantize")] + ["tilawa_tpu_torch.ops.specaug"] + [
        f"tilawa_tpu_torch.parallel.{m}" for m in ("mesh", "sharding", "dryrun")]
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"print(json.dumps(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {forbidden!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(REPO)})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cli_trains_on_the_cpu(tmp_path):
    """python -m tilawa_tpu_torch.train.train --device cpu, the small
    preset over v1, two steps and a checkpoint."""
    out = subprocess.run(
        [sys.executable, "-m", "tilawa_tpu_torch.train.train", "--device", "cpu",
         "--steps", "2", "--batch-size", "2", "--preset", "small",
         "--checkpoint-dir", str(tmp_path / "run")],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True,
    )
    assert "step     1" in out.stdout
    from tilawa_tpu_torch.train.checkpoint import load_variables

    cfg, variables = load_variables(tmp_path / "run" / "step_000002")
    assert cfg == tfc.FastConformerConfig.small()
    assert variables["params"]["blocks"]["block"]["ff1"]["lin1"]["kernel"].shape == (2, 64, 128)


def test_state_dict_keys_unchanged_for_bundles():
    """Float leaves are Parameters now; the state-dict keys (and strict
    loading of a bundle) are what they were."""
    from tilawa_tpu_torch.io.bundle import load_variables

    cfg, variables = load_variables(EXPORTS / "champion-int4")
    model = load_into(tfc.FastConformerCTC(cfg), variables)
    names = {n for n, _ in model.named_parameters()}
    assert "blocks.0.conv.bn.scale" in names and "blocks.0.conv.dw.kernel" in names
    assert not any(n.endswith(("packed", "scales", ".mean", ".var")) for n in names)
    assert set(model.state_dict()) == set(params_from_jax(variables))


def test_corpus_fit_matches_jax(tmp_path):
    """train.fit_report's per-clip CTC losses of one checkpoint (the small
    f32 config, written by the port) over the short v1 clips: within
    1e-5 rel, or 1e-3 absolute, the report's rounding to 3 decimals."""
    from tilawa_tpu.train.fit_report import corpus_fit as jax_fit
    from tilawa_tpu_torch.models.convert import variables_from_torch
    from tilawa_tpu_torch.train.checkpoint import save_variables
    from tilawa_tpu_torch.train.fit_report import corpus_fit

    cfg = tfc.FastConformerConfig.small(use_pallas=False)
    save_variables(tmp_path, cfg, variables_from_torch(ttrain.init_state(cfg, 4, "cpu")))
    ours = corpus_fit(str(tmp_path), ("v1",), max_audio_s=3.0, device="cpu")
    ref = jax_fit(str(tmp_path), ("v1",), max_audio_s=3.0)
    assert len(ours) >= 4 and [r["id"] for r in ours] == [r["id"] for r in ref]
    for a, b in zip(ours, ref):
        assert {k: v for k, v in a.items() if k != "loss"} == \
            {k: v for k, v in b.items() if k != "loss"}
        assert abs(a["loss"] - b["loss"]) <= max(1e-5 * abs(b["loss"]), 1e-3)
