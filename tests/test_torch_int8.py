"""Port's int8 quantization, int8 matmuls and Int8Dense models vs the JAX
package, on the CPU.

Tolerances and why:
* int8_matmul_plain vs JAX int8_matmul (Pallas, interpret mode) and
  int8_matmul_xla: 1e-4, as tests/test_quant.py holds the Pallas kernel to
  the XLA path: both sides multiply the same bf16 operands exactly in f32
  and differ only in the order of the f32 sums.
* int8_dense_plain vs flax Int8Dense in bf16: within one bf16 ulp
  (2^-7 relative) element by element, with fewer than 1% of the elements
  different at all: the product is rounded to bf16 on both sides from f32
  sums taken in another order, so a sum on a rounding boundary flips its
  last bit (measured: 0 to 3e-4 of the elements).
* the small config under quant="int8"/"mixed", f32: 1e-4 for int8 (the
  same f32 algorithm; measured ~5e-6), 1e-2 for mixed (x is rounded to bf16
  before each int4 product, so an upstream last-bit difference can flip
  one rounding; measured up to 2e-3); bf16: 5e-2 (bf16 rounding placement,
  as tests/test_torch_model.py states for int4; measured up to 2e-2). The
  per-frame argmax is equal in every case.
* full-width stream6-int8 Recognizer.transcribe_result on a v1 clip: equal
  text, token ids and t_valid; the JAX side runs with use_pallas=False.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.models import fastconformer as jfc  # noqa: E402
from tilawa_tpu.ops import quant as jq  # noqa: E402
from tilawa_tpu_torch.io.bundle import EXPORTS_DIR  # noqa: E402
from tilawa_tpu_torch.models import fastconformer as tfc  # noqa: E402
from tilawa_tpu_torch.models.convert import load_into, packed_size_bytes  # noqa: E402
from tilawa_tpu_torch.ops import kernels  # noqa: E402
from tilawa_tpu_torch.ops import quant as tq  # noqa: E402

STREAM6 = EXPORTS_DIR / "stream6-int8"
CORPUS = EXPORTS_DIR.parent / "benchmark" / "test_corpus"


def _int8_weights(k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return jq.quantize_int8(w)


@pytest.mark.parametrize("shape", [(64, 96), (512, 1025), (3, 2048, 512)])
def test_quantize_int8_copies_equal(shape):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    q_ours, s_ours = tq.quantize_int8(w)
    q_ref, s_ref = jq.quantize_int8(w)
    np.testing.assert_array_equal(q_ours, q_ref)
    np.testing.assert_array_equal(s_ours, s_ref)
    np.testing.assert_array_equal(tq.dequantize_int8(q_ours, s_ours),
                                  jq.dequantize_int8(q_ref, s_ref))


@pytest.mark.parametrize(
    "lead,m,k,n", [((), 10, 192, 256), ((), 50, 512, 1025), ((2,), 5, 128, 64), ((), 1, 2048, 512)]
)
def test_int8_matmul_plain_matches_jax(lead, m, k, n):
    q, scales = _int8_weights(k, n, m + k + n)
    x = np.random.default_rng(m * k).standard_normal((*lead, m, k)).astype(np.float32)
    ours = tq.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                torch.from_numpy(scales)).numpy()
    xla = np.asarray(jq.int8_matmul_xla(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scales)))
    pallas = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scales),
                                       interpret=True))
    assert ours.shape == xla.shape == pallas.shape == (*lead, m, n)
    np.testing.assert_allclose(ours, xla, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours, pallas, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("m,k,n,bias", [
    (50, 512, 1025, True), (99, 512, 512, False), (7, 2048, 512, True), (3, 64, 40, True),
])
def test_int8_dense_plain_matches_flax(m, k, n, bias):
    q, scales = _int8_weights(k, n, m + k + n)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    params = {"q": q, "scales": scales, **({"bias": b} if bias else {})}
    cfg = jfc.FastConformerConfig.small(quant="int8", dtype=jnp.bfloat16)
    ref = jfc.Int8Dense(n, cfg=cfg, use_bias=bias).apply({"params": params}, jnp.asarray(x))
    ref = np.asarray(ref.astype(jnp.float32))

    layer = tfc.Int8Dense(k, n, tfc.FastConformerConfig.small(quant="int8", dtype=torch.bfloat16),
                          use_bias=bias)
    layer.load_state_dict({k_: torch.from_numpy(v) for k_, v in params.items()})
    with torch.no_grad():
        ours = layer(torch.from_numpy(x))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    delta = np.abs(ours - ref)
    assert np.all(delta <= 2.0 ** -7 * np.abs(ref))
    assert (delta > 0).mean() < 1e-2


def test_cpu_tensors_take_plain_path_without_launch():
    q, scales = _int8_weights(64, 40, 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32))
    q, scales = torch.from_numpy(q), torch.from_numpy(scales)
    kernels.reset_launches()
    assert torch.equal(tq.int8_matmul(x, q, scales), tq.int8_matmul_plain(x, q, scales))
    assert torch.equal(tq.int8_dense(x, q, scales), tq.int8_dense_plain(x, q, scales))
    assert kernels.LAUNCHES["int8_matmul"] == 0
    assert "int8_matmul" in kernels.KERNELS


def _small_pair(quant, dtype, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lengths = np.array([16000, 9600], np.int32)
    jkw = dict(quant=quant, use_pallas=False)
    tkw = dict(quant=quant)
    if dtype == "bf16":
        jkw["dtype"], tkw["dtype"] = jnp.bfloat16, torch.bfloat16
    jm = jfc.FastConformerCTC(jfc.FastConformerConfig.small(**jkw))
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(audio), jnp.asarray(lengths))
    )
    ref, ref_lens = jm.apply(variables, jnp.asarray(audio), jnp.asarray(lengths))
    model = load_into(tfc.FastConformerCTC(tfc.FastConformerConfig.small(**tkw)), variables)
    with torch.no_grad():
        ours, our_lens = model(torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(our_lens.numpy(), np.asarray(ref_lens))
    return np.asarray(ref), ours.float().numpy(), np.asarray(ref_lens), model


@pytest.mark.parametrize("quant,dtype,atol", [
    ("int8", "f32", 1e-4), ("int8", "bf16", 5e-2), ("mixed", "f32", 1e-2), ("mixed", "bf16", 5e-2),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_small_int8_and_mixed_match_jax(quant, dtype, atol, seed):
    ref, ours, lens, model = _small_pair(quant, dtype, seed)
    for b, t in enumerate(lens):
        np.testing.assert_allclose(ours[b, :t], ref[b, :t], atol=atol)
        np.testing.assert_array_equal(ours[b, :t].argmax(-1), ref[b, :t].argmax(-1))
    kinds = {type(m).__name__ for m in model.modules()}
    assert "Int8Dense" in kinds
    assert ("Int4Dense" in kinds) == (quant == "mixed")
    if quant == "mixed":
        lin1 = model.blocks[0].ff1.lin1
        assert isinstance(lin1, tfc.Int4Dense) and isinstance(model.blocks[0].attn.q, tfc.Int8Dense)


def test_bundle_leftover_leaf_is_an_error():
    jm = jfc.FastConformerCTC(jfc.FastConformerConfig.small(quant="int8", use_pallas=False))
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.array([16000]))
    )
    variables = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    variables["params"]["ctc_head"] = dict(variables["params"]["ctc_head"], extra=np.zeros(3))
    with pytest.raises(RuntimeError, match="extra"):
        load_into(tfc.FastConformerCTC(tfc.FastConformerConfig.small(quant="int8")), variables)


def test_int8_dense_f32_model_raises_off_cpu():
    """The kernel computes bf16 models only: an f32 Int8Dense on a non-CPU
    tensor (here on the meta device) raises instead of running a library
    matmul."""
    layer = tfc.Int8Dense(8, 4, tfc.FastConformerConfig.small(quant="int8"))
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="bfloat16"):
        layer.to("meta")(x)


@pytest.fixture(scope="module")
def stream6_results():
    """One v1 clip through both stream6-int8 recognizers' transcribe_result
    (full width, 64000-sample bucket)."""
    from tilawa_tpu.data.audio import load_audio
    from tilawa_tpu.pipeline.predict import Recognizer as JaxRecognizer
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
    from tilawa_tpu_torch.eval.experiments import load_runtime
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    audio = load_audio(CORPUS / "retasy_003.wav")
    cfg, variables = jax_load_variables(STREAM6)
    jax_rec = JaxRecognizer(JaxRuntime(dataclasses.replace(cfg, use_pallas=False), variables))
    rec = Recognizer(load_runtime(STREAM6, "cpu", long_chunking=False))
    return jax_rec.transcribe_result(audio), rec.transcribe_result(audio), jax_rec, rec


def test_stream6_transcribe_result_matches_jax(stream6_results):
    ref, ours, _jax_rec, rec = stream6_results
    assert rec.runtime.config.quant == "int8" and rec.runtime.config.num_layers == 17
    assert ours.text and ours.text == ref.text
    assert ours.token_ids == ref.token_ids
    assert ours.t_valid == ref.t_valid
    # log-probs stay where the runtime put them, padded to a frame bucket
    assert isinstance(ours.log_probs, torch.Tensor) and ours.log_probs.shape[-1] == 1025


def test_stream6_model_size_matches_jax(stream6_results):
    _ref, _ours, jax_rec, rec = stream6_results
    assert rec.model_size() == jax_rec.model_size() == 111_483_400
    assert packed_size_bytes(rec.runtime.variables) == rec.model_size()
