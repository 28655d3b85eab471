"""Port's CTC scorer, collapse and padding helpers vs the JAX package.

Scores: both run the same f32 logaddexp recursion (the port stops its
frame loop at t_valid, where the JAX step becomes the identity); 1e-5."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.ops import ctc as jc  # noqa: E402
from tilawa_tpu.pipeline import rerank as jr  # noqa: E402
from tilawa_tpu_torch.ops import ctc as tc  # noqa: E402
from tilawa_tpu_torch.pipeline import rerank as tr  # noqa: E402

BLANK = 11


def _log_probs(rng, t, v=12):
    lp = rng.standard_normal((t, v)).astype(np.float32) * 2
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


TOKENS = [[1, 2, 3], [4, 4, 5], [], [1] * 20, [2, 2, 2, 2], [7, 1] * 7, [3], [5, 6, 5, 6, 5]]


@pytest.mark.parametrize("t_valid", [40, 31, 9, 1, 0])
def test_forward_scores_match_jax(t_valid):
    lp = _log_probs(np.random.default_rng(t_valid), 40)
    tokens, lengths = tc.pad_candidates(TOKENS, token_buckets=(32,), cand_buckets=(8,))
    ref = np.asarray(jc.ctc_forward_scores(
        jnp.asarray(lp), jnp.int32(t_valid), jnp.asarray(tokens), jnp.asarray(lengths), BLANK))
    ours = tc.ctc_forward_scores(
        torch.from_numpy(lp), t_valid, torch.from_numpy(tokens), torch.from_numpy(lengths), BLANK
    ).numpy()
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_collapse_and_padding_helpers():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, 4, size=rng.integers(0, 30))
        assert tc.collapse_ctc(ids, 3) == jc.collapse_ctc(ids, 3)
    for n in (1, 100, 128, 129, 512, 513, 5000):
        assert tc._next_bucket(n, tc.TOKEN_BUCKETS) == jc._next_bucket(n, jc.TOKEN_BUCKETS)
        assert tc._next_bucket(n, tc.FRAME_BUCKETS) == jc._next_bucket(n, jc.FRAME_BUCKETS)
    assert (tc.TOKEN_BUCKETS, tc.CAND_BUCKETS, tc.FRAME_BUCKETS) == (
        jc.TOKEN_BUCKETS, jc.CAND_BUCKETS, jc.FRAME_BUCKETS)
    for a, b in zip(tc.pad_candidates(TOKENS), jc.pad_candidates(TOKENS)):
        np.testing.assert_array_equal(a, b)
    lp = _log_probs(rng, 77)
    (pa, ta), (pb, tb) = tc.pad_frames(lp), jc.pad_frames(lp)
    assert ta == tb
    np.testing.assert_array_equal(pa, pb)


def test_score_token_lists_matches_jax():
    rng = np.random.default_rng(5)
    lp = _log_probs(rng, 60, v=1025)
    lists = [list(rng.integers(0, 1024, size=n)) for n in (3, 10, 29, 30, 0, 200, 17)]
    ref = jr.score_token_lists(lp, 60, lists, blank_id=1024)
    ours = tr.score_token_lists(lp, 60, lists, blank_id=1024)
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    # device-resident (frame-bucket padded) tensors score the same
    padded, t = tc.pad_frames(lp)
    on_device = tr.score_token_lists(torch.from_numpy(padded), t, lists, blank_id=1024)
    np.testing.assert_allclose(on_device, ours, rtol=1e-6)
