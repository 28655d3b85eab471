"""Port's int4 packing and plain dequant matmul vs the JAX package.

The JAX Pallas kernel runs in interpret mode (as tests/test_quant.py runs
it); tolerances 1e-4 as there: both sides multiply the same bf16 operands
exactly in f32 and differ only in the order of the f32 sums."""

import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.ops import quant as jq  # noqa: E402
from tilawa_tpu_torch.ops import kernels  # noqa: E402
from tilawa_tpu_torch.ops import quant as tq  # noqa: E402


@pytest.mark.parametrize("k,n", [(64, 96), (512, 1025), (2560, 64), (32, 16)])
def test_pack_unpack_copies_equal(k, n):
    rng = np.random.default_rng(k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    p_ours, s_ours = tq.pack_int4(w)
    p_ref, s_ref = jq.pack_int4(w)
    np.testing.assert_array_equal(p_ours, p_ref)
    np.testing.assert_array_equal(s_ours, s_ref)
    np.testing.assert_array_equal(tq.unpack_int4(p_ours, s_ours), jq.unpack_int4(p_ref, s_ref))


@pytest.mark.parametrize(
    "lead,m,k,n", [((), 50, 512, 1025), ((), 7, 2048, 128), ((2,), 5, 128, 64), ((), 1, 2560, 512)]
)
def test_plain_matches_jax(lead, m, k, n):
    rng = np.random.default_rng(m * k + n)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    packed, scales = jq.pack_int4(w)
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    ours = tq.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(packed),
                                torch.from_numpy(scales)).numpy()
    xla = np.asarray(jq.int4_matmul_xla(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales)))
    pallas = np.asarray(jq.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                       jnp.asarray(scales), interpret=True))
    assert ours.shape == xla.shape == (*lead, m, n)
    np.testing.assert_allclose(ours, xla, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours, pallas, atol=1e-4, rtol=1e-4)


def test_cpu_tensor_takes_plain_path_without_launch():
    rng = np.random.default_rng(0)
    packed, scales = tq.pack_int4(rng.standard_normal((64, 40)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    kernels.reset_launches()
    out = tq.int4_matmul(x, torch.from_numpy(packed), torch.from_numpy(scales))
    ref = tq.int4_matmul_plain(x, torch.from_numpy(packed), torch.from_numpy(scales))
    assert torch.equal(out, ref)
    assert kernels.LAUNCHES["int4_matmul"] == 0


def test_other_devices_raise():
    x = torch.empty((2, 64), device="meta")
    packed = torch.empty((32, 8), dtype=torch.uint8, device="meta")
    scales = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tq.int4_matmul(x, packed, scales)


# --------------------------------------------------------------------------
# The fused Int4Dense layer, the launch plan and the kernel build key
# --------------------------------------------------------------------------

from tilawa_tpu.models import fastconformer as jfc  # noqa: E402
from tilawa_tpu_torch.models import fastconformer as tfc  # noqa: E402

# (K, N) of the champion's int4 products (chip_smoke.py INT4_SHAPES)
INT4_SHAPES = [(2560, 512), (512, 512), (512, 1024), (512, 2048), (2048, 512), (512, 1025)]


def _int4_layer_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    packed, scales = tq.pack_int4((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, packed, scales, bias


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_dense_plain_is_the_layer_arithmetic(bias, dtype):
    """int4_dense_plain (and the layer on a CPU tensor) is bit-equal to the
    arithmetic Int4Dense had before the fused epilogue: the f32 product cast
    to the dtype, then plus the bias cast to the dtype."""
    x, packed, scales, b = (torch.from_numpy(a) for a in _int4_layer_case(37, 128, 96, 3))
    b = b if bias else None
    old = tq.int4_matmul_plain(x, packed, scales).to(dtype)
    if b is not None:
        old = old + b.to(dtype)
    new = tq.int4_dense_plain(x, packed, scales, b, dtype)
    assert new.dtype == dtype and torch.equal(new, old)
    assert torch.equal(tq.int4_dense(x, packed, scales, b, dtype), old)
    layer = tfc.Int4Dense(128, 96, tfc.FastConformerConfig.small(quant="int4", dtype=dtype),
                          use_bias=bias)
    layer.load_state_dict({"packed": packed, "scales": scales, **({"bias": b} if bias else {})})
    with torch.no_grad():
        assert torch.equal(layer(x), old)


@pytest.mark.parametrize("m,k,n,bias", [
    (50, 512, 1025, True), (99, 512, 512, False), (7, 2048, 512, True), (3, 64, 40, True),
])
def test_int4_dense_plain_matches_flax(m, k, n, bias):
    """Against flax Int4Dense (use_pallas=False) in bf16, held as
    tests/test_torch_int8.py holds Int8Dense: within one bf16 ulp element by
    element, under 1% of the elements different (f32 sums in another order
    can flip a rounding of the product); in f32, 1e-4 as the int4 product."""
    x, packed, scales, b = _int4_layer_case(m, k, n, m + k + n)
    params = {"packed": packed, "scales": scales, **({"bias": b} if bias else {})}
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        cfg = jfc.FastConformerConfig.small(quant="int4", dtype=jdt, use_pallas=False)
        ref = jfc.Int4Dense(n, cfg=cfg, use_bias=bias).apply({"params": params}, jnp.asarray(x))
        ref = np.asarray(ref.astype(jnp.float32))
        ours = tq.int4_dense_plain(torch.from_numpy(x), torch.from_numpy(packed),
                                   torch.from_numpy(scales),
                                   torch.from_numpy(b) if bias else None, tdt)
        assert ours.dtype == tdt
        ours = ours.float().numpy()
        if tdt == torch.float32:
            np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
            continue
        delta = np.abs(ours - ref)
        assert np.all(delta <= 2.0 ** -7 * np.abs(ref))
        assert (delta > 0).mean() < 1e-2


@pytest.mark.parametrize("k,n", INT4_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_split_independent_of_rows(k, n, sms):
    """The split-K factor of a product is a function of (K, N, SMs) alone
    (no M: a row's f32 sum order does not change with the rows launched
    beside it), at most one 8-block cluster, and its runs of 64-deep stages
    (the kernel's arithmetic) cover every stage once, none empty."""
    assert list(inspect.signature(tq.k_splits).parameters) == ["k", "n", "sms"]
    s = tq.k_splits(k, n, sms)
    assert 1 <= s <= 8
    stages = -(-k // 64)
    per = -(-stages // s)
    runs = [range(z * per, min(stages, (z + 1) * per)) for z in range(s)]
    assert all(len(r) > 0 for r in runs)
    assert [i for r in runs for i in r] == list(range(stages))
    if sms == 132:   # about one block per SM at one row tile of the paths' M
        assert 64 <= s * -(-n // 32) <= 132
    assert {tq.tile_n(m) for m in (1, 50, 99, 200, 256, 257, 399, 799)} == {32, 64, 128}


def test_library_key_covers_included_headers(tmp_path, monkeypatch):
    """An edited header builds anew: the library name hashes the .cu and
    every local header it includes."""
    for src in kernels.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC_DIR", tmp_path)
    assert {p.name for p in kernels.sources("int4_matmul")} == {"int4_matmul.cu",
                                                                "quant_matmul.cuh"}
    before = {name: kernels.library_path(name) for name in kernels.KERNELS}
    header = tmp_path / "quant_matmul.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: kernels.library_path(name) for name in kernels.KERNELS}
    assert after["int4_matmul"] != before["int4_matmul"]
    assert after["int8_matmul"] != before["int8_matmul"]
    assert after["log_mel"] == before["log_mel"]


@pytest.mark.parametrize("wrapper", ["int4_dense", "int8_dense"])
def test_layer_wrappers_reject_other_devices(wrapper):
    x = torch.empty((2, 64), device="meta")
    bias = torch.empty(8, device="meta")
    if wrapper == "int4_dense":
        args = (torch.empty((32, 8), dtype=torch.uint8, device="meta"),
                torch.empty((2, 8), device="meta"))
    else:
        args = (torch.empty((64, 8), dtype=torch.int8, device="meta"),
                torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        getattr(tq, wrapper)(x, *args, bias)
