"""The port's phoneme-head training path against the JAX package's, on the CPU.

* swap_head_for_phonemes: kernel [d_model, 70], bias 0, config vocab_size
  69 (blank 69), every other leaf kept; the head's std within STD_BAND of
  1/sqrt(d_model) (lecun normal; at 512 x 70 draws the sample std scatters
  by ~0.4%) and no draw past the ±2σ truncation. Its bits are torch's, not
  JAX's PRNG's: the step test below carries JAX's swapped head across.
* phoneme_corpus_batches (augment=False): for the same seed, the first
  batches equal JAX's bit for bit (audio, lengths, phoneme targets).
* one training step at the small config (f32, dropout 0), from JAX's
  swapped variables carried across with params_from_jax: loss and
  gradients at tests/test_torch_train.py's tolerances, live and frozen BN.
* prepare_init keeps a phoneme checkpoint's trained head (continuation);
  the CLI at --preset small trains on the CPU and its checkpoint loads in
  EncoderRuntime with [T, 70] log-probs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _jax_step, _np, _torch_step, assert_grads_match
from torch_threads import one_torch_thread  # noqa: F401

from tilawa_tpu.models import fastconformer as jfc
from tilawa_tpu.train import phoneme as jphoneme
from tilawa_tpu_torch.data.phonemes import PhonemeStore
from tilawa_tpu_torch.models import fastconformer as tfc
from tilawa_tpu_torch.models.convert import params_from_jax, variables_from_torch
from tilawa_tpu_torch.train import phoneme as tphoneme
from tilawa_tpu_torch.train.train import init_state

STD_BAND = 0.03      # |std / (1/sqrt(fan_in)) - 1|
SMALL = dict(dropout=0.0, use_pallas=False)


def test_swap_head_shapes_and_distribution():
    store = PhonemeStore.load_default()
    cfg = tfc.FastConformerConfig.large()
    variables = {"params": {"ctc_head": {"kernel": np.zeros((512, 1025), np.float32),
                                         "bias": np.ones(1025, np.float32)},
                            "other": {"kernel": np.ones((3, 3), np.float32)}},
                 "batch_stats": {"x": np.ones(2, np.float32)}}
    new_cfg, new_vars = tphoneme.swap_head_for_phonemes(cfg, variables, store.num_classes, seed=3)
    assert (new_cfg.vocab_size, new_cfg.blank_id, new_cfg.num_classes) == (69, 69, 70)
    head = new_vars["params"]["ctc_head"]
    assert head["kernel"].shape == (512, 70) and head["kernel"].dtype == np.float32
    assert np.array_equal(head["bias"], np.zeros(70, np.float32))
    assert new_vars["params"]["other"] is variables["params"]["other"]
    assert new_vars["batch_stats"] is variables["batch_stats"]
    assert variables["params"]["ctc_head"]["kernel"].shape == (512, 1025)   # input untouched
    std = 1 / np.sqrt(512)
    assert abs(head["kernel"].std() / std - 1) <= STD_BAND
    assert abs(head["kernel"]).max() <= 2 * std / 0.87962566103423978 + 1e-7
    again = tphoneme.swap_head_for_phonemes(cfg, variables, 70, seed=3)[1]
    assert np.array_equal(again["params"]["ctc_head"]["kernel"], head["kernel"])
    # JAX's head: the same distribution
    jcfg, jvars = jphoneme.swap_head_for_phonemes(jfc.FastConformerConfig(), variables, 70, seed=3)
    assert jcfg.vocab_size == 69
    assert abs(np.asarray(jvars["params"]["ctc_head"]["kernel"]).std() / std - 1) <= STD_BAND


def test_corpus_batches_equal_jax():
    ours = tphoneme.phoneme_corpus_batches(corpora=("v1", "v2", "v3"), seed=5, augment=False)
    theirs = jphoneme.phoneme_corpus_batches(corpora=("v1", "v2", "v3"), seed=5, augment=False)
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        assert int(a[2].max()) < 69   # phoneme ids, blank excluded


def _small_pair():
    """JAX's small config with JAX's swapped phoneme head (f32, dropout 0),
    and the port's config for the same variables."""
    jcfg = jfc.FastConformerConfig.small(**SMALL)
    variables = _np(jfc.FastConformerCTC(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.array([16000])))
    rng = np.random.default_rng(1)   # running stats away from (0, 1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    jcfg, variables = jphoneme.swap_head_for_phonemes(jcfg, variables, 70, seed=0)
    tcfg = tfc.FastConformerConfig.small(vocab_size=jcfg.vocab_size, **SMALL)
    return jcfg, tcfg, _np(variables)


def _phoneme_batch():
    """Two short v1 clips with their manifest verses' phoneme targets."""
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.runner import load_manifest
    from tilawa_tpu_torch.train.data import pad_batch

    store = PhonemeStore.load_default()
    samples, corpus_dir = load_manifest("v1")
    chunk = [(load_audio(corpus_dir / s["file"]), store.verse_ids(s["surah"], s["ayah"]))
             for s in samples if s["id"] in ("retasy_008", "retasy_014")]
    assert len(chunk) == 2 and all(ids for _a, ids in chunk)
    return pad_batch(chunk, max(len(a) for a, _ in chunk), 48)


@pytest.mark.parametrize("freeze_bn", [False, True], ids=["live-bn", "frozen-bn"])
def test_one_step_matches_jax(freeze_bn):
    jcfg, tcfg, variables = _small_pair()
    batch = _phoneme_batch()
    loss_j, grads_j, _bs = _jax_step(jcfg, variables, batch, freeze_bn)
    model, loss_t = _torch_step(tcfg, variables, batch, freeze_bn)
    assert np.isfinite(loss_j) and abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    ref = params_from_jax({"params": grads_j})
    params = dict(model.named_parameters())
    assert params["ctc_head.kernel"].shape == (64, 70)
    assert_grads_match(ref, params)


def test_prepare_init_keeps_a_phoneme_head(tmp_path):
    from tilawa_tpu_torch.train.checkpoint import save_variables

    cfg = tfc.FastConformerConfig.small(vocab_size=69)
    variables = variables_from_torch(init_state(cfg, seed=2, device="cpu"))
    save_variables(tmp_path / "ph", cfg, variables)
    kept_cfg, kept = tphoneme.prepare_init(tmp_path / "ph")
    assert kept_cfg == cfg
    assert np.array_equal(kept["params"]["ctc_head"]["kernel"],
                          variables["params"]["ctc_head"]["kernel"])
    text_cfg = dataclasses.replace(cfg, vocab_size=1024)
    swapped_cfg, swapped = tphoneme.prepare_init(
        "small", config=text_cfg,
        variables=variables_from_torch(init_state(text_cfg, seed=2, device="cpu")))
    assert swapped_cfg.vocab_size == 69
    assert not swapped["params"]["ctc_head"]["bias"].any()


def test_cli_small_preset_trains_and_loads(tmp_path):
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.experiments import load_runtime
    from tilawa_tpu_torch.io.bundle import EXPORTS_DIR

    assert tphoneme.main(["--device", "cpu", "--preset", "small", "--steps", "1",
                          "--corpora", "v1", "--checkpoint-dir", str(tmp_path)]) == 0
    rt = load_runtime(tmp_path / "step_000001", device="cpu")
    assert rt.config.vocab_size == 69
    audio = load_audio(EXPORTS_DIR.parent / "benchmark" / "test_corpus" / "retasy_008.wav")
    lp, t = rt.log_probs(audio)
    assert lp.shape[-1] == 70 and t > 0 and np.isfinite(lp[:t]).all()
