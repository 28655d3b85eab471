"""Port's FastConformer-CTC vs the JAX package's, on the CPU.

* small config, fp32, random JAX init converted: log-probs within 1e-4
  (same f32 algorithm; measured ~1e-5).
* small config, int4: x is rounded to bf16 before every int4 product, so a
  last-bit f32 difference upstream can flip one bf16 rounding (2^-8
  relative) and carry through the layers; measured up to 9e-3 over seeds,
  held to 3e-2 with equal per-frame argmax.
* champion-int4 at full width on two short v1 clips (one 64000-sample
  bucket, one JAX compile): collapsed greedy ids equal, max |Δ log-prob|
  reported (bf16 rounding points are the same; XLA's CPU fusion keeps some
  intermediates in f32 where torch rounds, measured ~0.5 on low-probability
  classes).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.data.audio import load_audio  # noqa: E402
from tilawa_tpu.models import fastconformer as jfc  # noqa: E402
from tilawa_tpu.ops.ctc import collapse_ctc  # noqa: E402
from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables  # noqa: E402
from tilawa_tpu_torch.io.bundle import EXPORTS_DIR, load_variables  # noqa: E402
from tilawa_tpu_torch.models import fastconformer as tfc  # noqa: E402
from tilawa_tpu_torch.models.convert import load_into  # noqa: E402

CLIPS = ("retasy_000.wav", "retasy_002.wav")
CORPUS = EXPORTS_DIR.parent / "benchmark" / "test_corpus"


def _small_pair(quant, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lengths = np.array([16000, 9600], np.int32)
    jm = jfc.FastConformerCTC(jfc.FastConformerConfig.small(quant=quant, use_pallas=False))
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(audio), jnp.asarray(lengths))
    )
    ref, ref_lens = jm.apply(variables, jnp.asarray(audio), jnp.asarray(lengths))
    model = load_into(tfc.FastConformerCTC(tfc.FastConformerConfig.small(quant=quant)), variables)
    with torch.no_grad():
        ours, our_lens = model(torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(our_lens.numpy(), np.asarray(ref_lens))
    return np.asarray(ref), ours.numpy(), np.asarray(ref_lens)


@pytest.mark.parametrize("seed", [0, 1])
def test_small_fp32_matches_jax(seed):
    ref, ours, lens = _small_pair(None, seed)
    for b, t in enumerate(lens):
        np.testing.assert_allclose(ours[b, :t], ref[b, :t], atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_small_int4_matches_jax(seed):
    ref, ours, lens = _small_pair("int4", seed)
    for b, t in enumerate(lens):
        np.testing.assert_allclose(ours[b, :t], ref[b, :t], atol=3e-2)
        np.testing.assert_array_equal(ours[b, :t].argmax(-1), ref[b, :t].argmax(-1))


def test_padding_invariance():
    """Valid-region log-probs do not change when the batch carries more
    padding (the bucketing contract)."""
    cfg = tfc.FastConformerConfig.small()
    torch.manual_seed(0)
    model = tfc.FastConformerCTC(cfg)
    for buf in model.state_dict().values():
        if buf.dtype == torch.float32 and buf.dim() >= 1:
            buf.copy_(torch.randn_like(buf) * 0.1 + (1.0 if buf.dim() == 1 else 0.0))
    audio = torch.from_numpy(np.random.default_rng(1).normal(0, 0.1, 9600).astype(np.float32))
    padded = torch.zeros(16000)
    padded[:9600] = audio
    with torch.no_grad():
        a, la = model(audio[None], torch.tensor([9600]))
        b, lb = model(padded[None], torch.tensor([9600]))
    t = int(la[0])
    assert int(lb[0]) == t
    np.testing.assert_allclose(a[0, :t].numpy(), b[0, :t].numpy(), atol=1e-5)


def test_subsampled_length_matches_jax():
    lengths = np.arange(0, 2000, 7)
    np.testing.assert_array_equal(
        tfc.subsampled_length(torch.from_numpy(lengths)).numpy(),
        np.asarray(jfc.subsampled_length(jnp.asarray(lengths))),
    )


@pytest.fixture(scope="module")
def champion_pair():
    """One [2, 64000] batch of two v1 clips through both champions."""
    cfg, variables = jax_load_variables(EXPORTS_DIR / "champion-int4")
    jm = jfc.FastConformerCTC(dataclasses.replace(cfg, use_pallas=False))
    batch = np.zeros((2, 64000), np.float32)
    lengths = np.zeros(2, np.int32)
    for i, clip in enumerate(CLIPS):
        a = load_audio(CORPUS / clip)
        # the int16 PCM round trip both runtimes apply on upload
        batch[i, : len(a)] = np.clip(a * 32768.0, -32768, 32767).astype(np.int16) / 32768.0
        lengths[i] = len(a)
    ref, ref_lens = jax.jit(jm.apply)(variables, jnp.asarray(batch), jnp.asarray(lengths))
    tcfg, tvars = load_variables(EXPORTS_DIR / "champion-int4")
    model = load_into(tfc.FastConformerCTC(tcfg), tvars)
    with torch.no_grad():
        ours, our_lens = model(torch.from_numpy(batch), torch.from_numpy(lengths))
    return np.asarray(ref), np.asarray(ref_lens), ours.float().numpy(), our_lens.numpy()


def test_champion_greedy_ids_match_jax(champion_pair):
    ref, ref_lens, ours, our_lens = champion_pair
    np.testing.assert_array_equal(our_lens, ref_lens)
    for b, t in enumerate(ref_lens):
        ids_ref = collapse_ctc(ref[b, :t].argmax(-1), 1024)
        ids_ours = collapse_ctc(ours[b, :t].argmax(-1), 1024)
        delta = float(np.abs(ours[b, :t] - ref[b, :t]).max())
        print(f"{CLIPS[b]}: T={t} tokens={len(ids_ref)} max|Δ log-prob|={delta:.4g}")
        assert ids_ours == ids_ref
        assert len(ids_ref) > 0


def test_champion_log_probs_are_distributions(champion_pair):
    _ref, _lens, ours, our_lens = champion_pair
    assert ours.shape[-1] == 1025 and np.isfinite(ours).all()
    np.testing.assert_allclose(np.exp(ours[0, : our_lens[0]]).sum(-1), 1.0, atol=1e-4)
