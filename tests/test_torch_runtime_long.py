"""Port's chunked long-clip forward and streaming encoder cache, mirroring
tests/test_runtime_long.py, and held against the JAX package's on the small
config (CPU, f32, JAX-initialized variables).

Tolerances: port vs JAX forward_long, 1e-4 on the valid log-probs (the
same f32 algorithm, measured ~1e-5 as in tests/test_torch_model.py) with
equal t_valid and ids; the cache vs forward_long, 1e-5 with equal t_valid
and ids (the same windows through the same model; only the batch size of
the forward differs).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.models import fastconformer as jfc  # noqa: E402
from tilawa_tpu.pipeline import runtime as jrt  # noqa: E402
from tilawa_tpu_torch.models.fastconformer import FastConformerConfig, subsampled_length  # noqa: E402
from tilawa_tpu_torch.ops.frontend import num_frames  # noqa: E402
from tilawa_tpu_torch.pipeline.runtime import (  # noqa: E402
    LONG_CHUNK,
    LONG_STEP,
    LONG_THRESHOLD,
    _JUNCTION_TRIM,
    EncoderRuntime,
    StreamingEncoderCache,
)


@pytest.fixture(scope="module")
def variables():
    jm = jfc.FastConformerCTC(jfc.FastConformerConfig.small(use_pallas=False))
    return jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32000)), jnp.array([32000]))
    )


@pytest.fixture(scope="module")
def runtime(variables):
    return EncoderRuntime(FastConformerConfig.small(), variables, device="cpu", long_chunking=True)


@pytest.fixture(scope="module")
def jax_runtime(variables):
    return jrt.EncoderRuntime(
        jfc.FastConformerConfig.small(use_pallas=False), variables, long_chunking=True
    )


def test_constants_match_jax():
    assert (LONG_CHUNK, LONG_STEP, LONG_THRESHOLD, _JUNCTION_TRIM) == (
        jrt.LONG_CHUNK, jrt.LONG_STEP, jrt.LONG_THRESHOLD, jrt._JUNCTION_TRIM
    )
    assert StreamingEncoderCache.MAX_ENTRIES == jrt.StreamingEncoderCache.MAX_ENTRIES


def test_chunk_count_boundaries():
    assert EncoderRuntime.chunk_count(LONG_THRESHOLD) == 1
    assert EncoderRuntime.chunk_count(LONG_THRESHOLD + 1) == 2
    assert EncoderRuntime.chunk_count(LONG_STEP + LONG_CHUNK) == 2
    assert EncoderRuntime.chunk_count(LONG_STEP + LONG_CHUNK + 1) == 3
    for n in (300000, 500000, 830000, 1700000):
        k = EncoderRuntime.chunk_count(n)
        assert k == jrt.EncoderRuntime.chunk_count(n)
        assert (k - 1) * LONG_STEP + LONG_CHUNK >= n
        assert n - (k - 1) * LONG_STEP > 0


def test_forward_routes_long(runtime):
    rng = np.random.default_rng(0)
    audio = rng.normal(scale=0.1, size=300000).astype(np.float32)  # 18.75 s
    runtime.forwards = 0
    lp, ids, t_valid = runtime.forward(audio)

    tc = subsampled_length(num_frames(LONG_CHUNK))
    t_last = subsampled_length(num_frames(300000 - LONG_STEP))
    assert t_valid == (tc - _JUNCTION_TRIM) + (t_last - _JUNCTION_TRIM)
    assert len(ids) == t_valid
    assert abs(t_valid - 300000 / 1280) < 16
    assert lp.shape[0] >= t_valid and lp.shape[1] == runtime.config.vocab_size + 1
    assert runtime.forwards == 1   # one [K, LONG_CHUNK] batch
    # without chunking the same clip takes one full-window forward
    runtime.long_chunking = False
    try:
        _lp, ids_full, t_full = runtime.forward(audio)
    finally:
        runtime.long_chunking = True
    assert abs(t_full - t_valid) <= 2 and len(ids_full) == t_full


@pytest.mark.parametrize("n", [300000, 520000])
def test_forward_long_matches_jax(runtime, jax_runtime, n):
    audio = np.random.default_rng(n).normal(scale=0.1, size=n).astype(np.float32)
    lp, ids, t_valid = runtime.forward_long(audio)
    lp_ref, ids_ref, t_ref = jax_runtime.forward_long(audio)
    assert t_valid == t_ref
    assert lp.shape == tuple(lp_ref.shape)
    np.testing.assert_array_equal(ids, np.asarray(ids_ref))
    np.testing.assert_allclose(lp[:t_valid].numpy(), np.asarray(lp_ref)[:t_ref], atol=1e-4)


def test_streaming_cache_matches_forward_long(runtime):
    """The growing-window cache path gives forward_long's t_valid, ids and
    log-probs, and reuses its windows as the window grows."""
    rng = np.random.default_rng(2)
    full = rng.normal(scale=0.1, size=560000).astype(np.float32)  # 35 s

    cache = StreamingEncoderCache(runtime)
    for n in (280000, 400000, 520000, 560000):   # growing discovery window
        lp_c, ids_c, tv_c = cache.forward(full[:n])
        lp_f, ids_f, tv_f = runtime.forward_long(full[:n])
        assert tv_c == tv_f
        assert list(ids_c) == list(ids_f)
        np.testing.assert_allclose(lp_c[:tv_c].numpy(), lp_f[:tv_f].numpy(), atol=1e-5)
    assert cache.hits >= 3  # chunk 0 re-used on every later cycle
    lp_s, ids_s, tv_s = cache.forward(full[:200000])   # short windows: plain forward
    assert tv_s > 0 and len(ids_s) == tv_s


def test_streaming_cache_evicts_oldest(runtime, monkeypatch):
    monkeypatch.setattr(StreamingEncoderCache, "MAX_ENTRIES", 2)
    cache = StreamingEncoderCache(runtime)
    rng = np.random.default_rng(3)
    for _ in range(2):   # four windows each, three of them cached
        n = 3 * LONG_STEP + LONG_CHUNK - 1000
        cache.forward(rng.normal(scale=0.1, size=n).astype(np.float32))
    assert len(cache._cache) == 2 and cache.misses == 6 and cache.hits == 0


def test_stitched_timeline_vs_full(runtime):
    """The stitched timeline loses 2*trim frames per junction relative to
    the full-clip forward, and its valid rows are log-probs."""
    rng = np.random.default_rng(1)
    audio = rng.normal(scale=0.1, size=320000).astype(np.float32)  # 20 s
    lp_c, ids_c, tv_c = runtime.forward_long(audio)
    _lp_f, lens_f, _ids_f = runtime.forward_batch([audio])
    assert abs(int(lens_f[0]) - tv_c) <= 2
    row = lp_c[:tv_c].numpy()
    assert np.all(np.isfinite(row))
    np.testing.assert_allclose(np.exp(row).sum(axis=-1), 1.0, atol=1e-3)
    assert len(ids_c) == tv_c


@pytest.mark.parametrize("value,on", [("1", True), ("", False), ("0", False), ("false", False)])
def test_int16_upload_knob_is_read_at_construction(variables, monkeypatch, value, on):
    monkeypatch.setenv("TILAWA_INT16_UPLOAD", value)
    rt = EncoderRuntime(FastConformerConfig.small(), variables, device="cpu")
    monkeypatch.setenv("TILAWA_INT16_UPLOAD", "0" if on else "1")
    assert rt.int16_upload is on


def test_f32_upload_matches_jax(variables, runtime, monkeypatch):
    """TILAWA_INT16_UPLOAD=0: forward and forward_long upload f32 audio, as
    the JAX package's do; log-probs within 1e-4 of JAX's with equal ids (the
    tolerance of the int16 parity tests above), and not those of the int16
    upload."""
    monkeypatch.setenv("TILAWA_INT16_UPLOAD", "0")
    ours = EncoderRuntime(FastConformerConfig.small(), variables, device="cpu", long_chunking=True)
    ref = jrt.EncoderRuntime(jfc.FastConformerConfig.small(use_pallas=False), variables,
                             long_chunking=True)
    assert not ours.int16_upload and not ref._int16_upload
    rng = np.random.default_rng(5)
    for n in (40000, 300000):   # one bucketed forward, one chunked forward_long
        audio = rng.normal(scale=0.1, size=n).astype(np.float32)
        lp, ids, t_valid = ours.forward(audio)
        lp_ref, ids_ref, t_ref = ref.forward(audio)
        assert t_valid == t_ref
        np.testing.assert_array_equal(ids, np.asarray(ids_ref))
        np.testing.assert_allclose(lp[:t_valid].numpy(), np.asarray(lp_ref)[:t_ref], atol=1e-4)
        lp16, _ids16, t16 = runtime.forward(audio)   # the int16 upload
        assert t16 == t_valid and not torch.equal(lp16[:t16], lp[:t_valid])
