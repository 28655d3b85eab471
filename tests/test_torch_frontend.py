"""Port's log-mel frontend vs the JAX package's.

Tolerances: the port and JAX both run framing + rfft + f32 mel products,
with FFTs and f32 sums in their own orders; measured differences are
~4e-5 on the normalized features and ~3e-5 on the log-mels. The Pallas
kernel (interpret mode) is a direct DFT, held to the plain version with
the bound tests/test_frontend.py holds it to against its own rfft path."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.ops import frontend as jf  # noqa: E402
from tilawa_tpu_torch.ops import frontend as tf  # noqa: E402
from tilawa_tpu_torch.ops import kernels  # noqa: E402


def _pre(audio: np.ndarray) -> np.ndarray:
    return np.concatenate([audio[:, :1], audio[:, 1:] - 0.97 * audio[:, :-1]], axis=1)


def test_host_helpers_are_copies():
    np.testing.assert_array_equal(tf.mel_filterbank(), jf.mel_filterbank())
    np.testing.assert_array_equal(tf.hann_window(), jf.hann_window())
    lengths = np.array([0, 1, 399, 400, 401, 559, 560, 16000, 12345])
    for n in lengths:
        assert tf.num_frames(int(n)) == jf.num_frames(int(n))
    np.testing.assert_array_equal(
        tf.frames_for_length(torch.from_numpy(lengths)).numpy(),
        np.asarray(jf.frames_for_length(jnp.asarray(lengths))),
    )


def test_twiddles_are_float64_rounded_once():
    ang = 2.0 * np.pi * np.arange(512, dtype=np.float64) / 512
    tw = tf.twiddles()
    assert tw.dtype == np.float32 and tw.shape == (512, 2)
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))


def test_mel_bands_reproduce_the_filterbank():
    """Every non-zero weight of mel_filterbank() sits in its mel's band at
    its bin, nothing lies outside a band, and the bands are the contiguous
    runs the kernel sums (1-17 bins, each bin in at most two mels)."""
    fb = tf.mel_filterbank()
    bands, weights = tf.mel_bands()
    assert bands.dtype == np.int32 and bands.shape == (80, 3) and weights.dtype == np.float32
    dense = np.zeros_like(fb)
    for m, (first, count, offset) in enumerate(bands):
        band = weights[offset:offset + count]
        assert np.all(band != 0), f"mel {m}: a zero inside its band"
        dense[first:first + count, m] = band
    np.testing.assert_array_equal(dense, fb)
    np.testing.assert_array_equal(bands[1:, 2], np.cumsum(bands[:-1, 1]))
    assert len(weights) == bands[-1, 1] + bands[-1, 2] == int((fb != 0).sum()) == 503
    assert bands[:, 1].min() >= 1 and bands[:, 1].max() <= 17
    assert int((fb != 0).sum(axis=1).max()) <= 2


def test_band_sums_equal_the_dense_mel_product():
    rng = np.random.default_rng(5)
    power = rng.exponential(size=(7, 257))
    bands, weights = tf.mel_bands()
    sums = np.stack([
        power[:, first:first + count] @ weights[offset:offset + count].astype(np.float64)
        for first, count, offset in bands
    ], axis=1)
    dense = power @ tf.mel_filterbank().astype(np.float64)
    np.testing.assert_allclose(sums, dense, rtol=1e-12, atol=0)


def test_mel_tables_are_the_host_tables():
    tables = tf.mel_tables()
    bands, weights = tf.mel_bands()
    assert tables._fields == ("window", "fb", "twiddle", "bands", "band_weights")
    for got, want in zip(tables, (tf.hann_window(), tf.mel_filterbank(), tf.twiddles(),
                                  bands, weights)):
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tables.window.numpy(), jf.hann_window())


@pytest.mark.parametrize("seed,n,lengths", [
    (0, 16000, [16000, 12345, 401]),
    (1, 12345, [12345, 7000]),
    (2, 64000, [37104]),
])
def test_log_mel_spectrogram_matches_jax(seed, n, lengths):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((len(lengths), n)) * 0.1).astype(np.float32)
    for i, length in enumerate(lengths):
        audio[i, length:] = 0.0
    lens = np.array(lengths, np.int32)
    ref, ref_lens = jf.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(lens), use_pallas=False)
    ours, our_lens = tf.log_mel_spectrogram(
        torch.from_numpy(audio), torch.from_numpy(lens), tf.mel_tables()
    )
    np.testing.assert_array_equal(our_lens.numpy(), np.asarray(ref_lens))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("n", [16000, 12345, 4321])
def test_plain_log_mel_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    pre = _pre((rng.standard_normal((2, n)) * 0.1).astype(np.float32))
    ref = np.asarray(jf.fused_log_mel(jnp.asarray(pre), interpret=True))
    ours = tf.log_mel_plain(torch.from_numpy(pre), tf.mel_tables()).numpy()
    assert ours.shape == ref.shape == (2, tf.num_frames(n), 80)
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=2e-3)


def test_cpu_tensor_takes_plain_path_without_launch():
    pre = torch.from_numpy(_pre(np.random.default_rng(3).standard_normal((1, 8000)).astype(np.float32)))
    tables = tf.mel_tables()
    kernels.reset_launches()
    assert torch.equal(tf.fused_log_mel(pre, tables), tf.log_mel_plain(pre, tables))
    assert kernels.LAUNCHES["log_mel"] == 0


def test_other_devices_raise():
    with pytest.raises(ValueError, match="cuda or cpu"):
        tf.fused_log_mel(torch.empty((1, 8000), device="meta"), tf.mel_tables("meta"))


def test_features_of_a_row_do_not_depend_on_the_batch():
    """A row's normalized features are bitwise the same alone and batched
    with other rows (its time statistics are summed row by row)."""
    rng = np.random.default_rng(4)
    audio = torch.from_numpy((rng.standard_normal((3, 48000)) * 0.1).astype(np.float32))
    lengths = torch.tensor([48000, 30000, 41000], dtype=torch.int32)
    tables = tf.mel_tables()
    batched, lens = tf.log_mel_spectrogram(audio, lengths, tables)
    for b in range(3):
        alone, lens_b = tf.log_mel_spectrogram(audio[b:b + 1], lengths[b:b + 1], tables)
        assert torch.equal(lens_b, lens[b:b + 1])
        assert torch.equal(alone.view(torch.int32), batched[b:b + 1].view(torch.int32))
