"""Port's int4 packing and plain dequant matmul vs the JAX package.

The JAX Pallas kernel runs in interpret mode (as tests/test_quant.py runs
it); tolerances 1e-4 as there: both sides multiply the same bf16 operands
exactly in f32 and differ only in the order of the f32 sums."""

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
