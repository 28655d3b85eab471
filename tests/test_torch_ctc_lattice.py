"""The port's CTC lattice scorer against the JAX package's, on CPU tensors.

On a CPU tensor `ctc_forward_scores` and `ctc_forward_scores_batch` run
their plain versions (the CUDA kernel csrc/ctc_lattice.cu is held to those
on the card by tests/test_torch_cuda.py and chip_smoke.py). Both packages
run the same f32 logaddexp recursion, the port stopping its frame loop at
t_valid, where the JAX step becomes the identity: scores within rtol/atol
1e-5, with equal +inf patterns."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.ops import ctc as jc  # noqa: E402
from tilawa_tpu.pipeline import rerank as jr  # noqa: E402
from tilawa_tpu_torch.ops import ctc as tc  # noqa: E402
from tilawa_tpu_torch.ops import kernels  # noqa: E402
from tilawa_tpu_torch.pipeline import rerank as tr  # noqa: E402

TOL = 1e-5


def _log_probs(rng, shape):
    lp = rng.standard_normal(shape).astype(np.float32) * 2
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def _candidates(rng, lengths, l_pad, vocab, blank, c_pad):
    """[c_pad, l_pad] zero-padded tokens (never the blank; some with runs
    of a repeated token) and their lengths; rows past len(lengths) are
    padding."""
    tokens = np.zeros((c_pad, l_pad), np.int32)
    lens = np.zeros(c_pad, np.int32)
    labels = np.array([v for v in range(vocab) if v != blank])
    for i, n in enumerate(lengths):
        ids = rng.choice(labels, size=n)
        if i % 3 == 0 and n > 4:
            ids[1:4] = ids[0]          # a run: no skip transition inside it
        tokens[i, :n] = ids
        lens[i] = n
    return tokens, lens


def _assert_scores(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def _both(lp, t_valid, tokens, lens, blank):
    ref = jc.ctc_forward_scores(jnp.asarray(lp), jnp.int32(t_valid), jnp.asarray(tokens),
                                jnp.asarray(lens), blank)
    ours = tc.ctc_forward_scores(torch.from_numpy(lp), t_valid, torch.from_numpy(tokens),
                                 torch.from_numpy(lens), blank)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("t_valid", [2001, 2000, 1500])
def test_phoneme_vocabulary_near_the_feasibility_edge(t_valid):
    """V = 70 (phoneme-int8), L_pad 1,024: rows at L = 1,000 (2L+1 = 2,001,
    exactly feasible at t_valid 2,001) and L = 1,001 (just past it), and
    shorter ones."""
    rng = np.random.default_rng(t_valid)
    blank = 69
    lp = _log_probs(rng, (2048, 70))
    tokens, lens = _candidates(rng, [1000, 1001, 999, 730, 64, 7, 1], 1024, 70, blank, 8)
    ours, ref = _both(lp, t_valid, tokens, lens, blank)
    _assert_scores(ours, ref)
    np.testing.assert_array_equal(np.isfinite(ours), (2 * lens + 1 <= t_valid) & (lens > 0))
    assert np.isfinite(ours[0]) == (t_valid == 2001) and np.isinf(ours[1])


def test_chunk_of_mostly_padding_rows():
    """A 64-row chunk at L_pad 128 (V 1025, the BPE models) with 5 live
    candidates, t_valid < T: the padded rows are +inf in both."""
    rng = np.random.default_rng(3)
    lp = _log_probs(rng, (512, 1025))
    tokens, lens = _candidates(rng, [128, 100, 57, 3, 1], 128, 1025, 1024, 64)
    ours, ref = _both(lp, 257, tokens, lens, 1024)
    _assert_scores(ours, ref)
    assert np.isfinite(ours[:5]).all() and np.isinf(ours[5:]).all()


@pytest.mark.parametrize("t_valids", [(0, 23, 40), (1, 40, 23), (40, 0, 1)])
def test_batch_form_matches_jax_vmap(t_valids):
    """B = 3 log-prob matrices with per-row t_valid across 0, 1, a middle
    value and T, against JAX's vmap (ctc_forward_scores_batch)."""
    rng = np.random.default_rng(sum(t_valids))
    lp = _log_probs(rng, (3, 40, 12))
    tokens, lens = _candidates(rng, [3, 11, 19, 20, 1, 8], 32, 12, 11, 8)
    t_valid = np.array(t_valids, np.int32)
    ref = np.asarray(jc.ctc_forward_scores_batch(jnp.asarray(lp), jnp.asarray(t_valid),
                                                 jnp.asarray(tokens), jnp.asarray(lens), 11))
    ours = tc.ctc_forward_scores_batch(torch.from_numpy(lp), torch.from_numpy(t_valid),
                                       torch.from_numpy(tokens), torch.from_numpy(lens), 11)
    assert ours.shape == (3, 8)
    _assert_scores(ours.numpy(), ref)
    for b, tv in enumerate(t_valids):   # each row is the single form at its own t_valid
        single = tc.ctc_forward_scores(torch.from_numpy(lp[b]), tv, torch.from_numpy(tokens),
                                       torch.from_numpy(lens), 11)
        np.testing.assert_array_equal(ours[b].numpy(), single.numpy())


def test_score_token_lists_across_chunks(monkeypatch):
    """score_token_lists on a frame-bucket padded tensor with the candidate
    bucket forced to 64 (TILAWA_RERANK_GATHER_BYTES): 150 lists in two
    token buckets make several `_score_feasible` chunks; the scores equal
    the JAX package's and the port's unchunked run."""
    rng = np.random.default_rng(11)
    lp = _log_probs(rng, (300, 1025))
    lists = [list(rng.integers(0, 1024, size=n)) for n in rng.integers(0, 160, size=150)]
    lists[7] = [5, 5, 5, 9]
    lists[8] = list(rng.integers(0, 1024, size=150))   # 2L+1 = 301: infeasible
    ref = jr.score_token_lists(lp, 300, lists, blank_id=1024)
    padded, t = tc.pad_frames(lp)
    whole = tr.score_token_lists(torch.from_numpy(padded), t, lists, blank_id=1024)

    calls = []
    real = tr.ctc_forward_scores

    def counted(*args):
        calls.append(tuple(args[2].shape))
        return real(*args)

    monkeypatch.setattr(tr, "_MAX_GATHER_BYTES", 1)
    monkeypatch.setattr(tr, "ctc_forward_scores", counted)
    chunked = tr.score_token_lists(torch.from_numpy(padded), t, lists, blank_id=1024)
    assert len(calls) >= 3 and {c for c, _l in calls} == {64}
    assert {l_pad for _c, l_pad in calls} == {128, 512}
    _assert_scores(chunked, ref)
    _assert_scores(chunked, whole)
    assert np.isinf(chunked[8]) and np.isfinite(chunked[7])


def test_cpu_route_never_builds_or_counts_the_kernel(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("the CPU route built a kernel")

    monkeypatch.setattr(kernels, "function", no_build)
    monkeypatch.setattr(kernels, "build", no_build)
    kernels.reset_launches()
    rng = np.random.default_rng(2)
    lp = torch.from_numpy(_log_probs(rng, (2, 30, 12)))
    tokens, lens = (torch.from_numpy(a) for a in _candidates(rng, [3, 5], 8, 12, 11, 4))
    tc.ctc_forward_scores(lp[0], 30, tokens, lens, 11)
    tc.ctc_forward_scores_batch(lp, torch.tensor([30, 9]), tokens, lens, 11)
    tr.score_token_lists(lp[0].numpy(), 30, [[1, 2], [3]], blank_id=11)
    assert kernels.LAUNCHES["ctc_lattice"] == 0
    assert "ctc_lattice" in kernels.KERNELS


def test_wrappers_compute_forward_only():
    """An input that requires a gradient under grad mode raises (no output
    without a grad_fn), on the CPU as on the card; under no_grad it runs."""
    lp = torch.zeros((20, 6), requires_grad=True)
    tokens, lens = torch.tensor([[1, 2, 0]]), torch.tensor([2])
    with pytest.raises(RuntimeError, match="forward only"):
        tc.ctc_forward_scores(lp, 20, tokens, lens, 5)
    with pytest.raises(RuntimeError, match="forward only"):
        tc.ctc_forward_scores_batch(lp[None], torch.tensor([20]), tokens, lens, 5)
    with torch.no_grad():
        assert torch.isfinite(tc.ctc_forward_scores(lp, 20, tokens, lens, 5)).all()


def test_wrappers_reject_other_devices():
    lp = torch.empty((20, 6), device="meta")
    tokens, lens = torch.empty((1, 3), dtype=torch.int32, device="meta"), \
        torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tc.ctc_forward_scores(lp, 20, tokens, lens, 5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tc.ctc_forward_scores_batch(lp[None], torch.tensor([20]), tokens, lens, 5)
