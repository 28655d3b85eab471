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


# The lattice kernel's launch plan (ops/ctc.py lattice_plan) and the
# rerank's chunk plan (pipeline/rerank.py _chunks): pure host functions, so
# they are held here; the kernel runs each plan on the card
# (tests/test_torch_cuda.py -k lattice, chip_smoke.py).

_H100_SMEM = 232448      # shared memory a block may use
_H100_CLUSTER = 16       # past the portable size: where 8 CTAs cannot hold a candidate
_CASES = __import__("chip_smoke").LATTICE_CASES
_CASE_SHAPES = sorted({(l_pad, c, 1) for _label, _t, _v, c, l_pad, _tv, _ls in _CASES}
                      | {(128, 64, 4)})
# every token bucket up to L_pad 3,072 (_next_bucket: the rungs, then
# multiples of the last), the rungs a TILAWA_TOKEN_BUCKETS ladder may add
# below them, and the widths around each variant's edge
_BUCKETS = sorted({tc._next_bucket(n, tc.TOKEN_BUCKETS) for n in range(1, 3073)}
                  | {1, 16, 31, 32, 33, 64, 255, 256, 511, 513})


def _holds(plan, l_max):
    """The plan's layout holds l_max + 1 state pairs, one a thread
    (csrc/ctc_lattice.cu's own test before it launches)."""
    if plan.cluster == 1:
        return 32 * plan.warps >= l_max + 1
    # a CTA's slice in whole warps, beside its halo warp
    return -(-(-(-(l_max + 1) // plan.cluster)) // 32) * 32 <= 32 * (plan.warps - 1)


def _fits_the_card(plan):
    limit = tc.GROUP_THREADS if plan.cluster == 1 else tc.CLUSTER_THREADS
    return (plan.threads <= limit and plan.smem <= _H100_SMEM
            and plan.cluster in ((1,) if plan.variant != "cluster" else (8, 16))
            and plan.cluster <= _H100_CLUSTER
            and 1 <= plan.slots <= tc.MAX_SLOTS and plan.warps * plan.slots <= 32
            and (plan.cluster == 1 or plan.slots == 1)
            and 1 <= plan.grid[1] <= 65535 and 1 <= plan.grid[0] < 2**31)


@pytest.mark.parametrize("l_pad,c,b", _CASE_SHAPES + [(l, 512, 1) for l in _BUCKETS])
def test_lattice_plan_fits_the_card(l_pad, c, b):
    """Every chip_smoke.LATTICE_CASES shape (with no t_valid, and with each
    of its rows' t_valid), the batch form's and every token bucket up to
    3,072 (C 512, the rerank's chunk) get a variant whose threads, shared
    memory and cluster fit the H100 and whose layout holds the longest
    candidate that can be feasible; the plan is a pure function of (L_pad,
    C, B, t_valid)."""
    t_valids = [None] + [tv for _l, _t, _v, cc, lp, tv, _ls in _CASES
                         if (lp, cc) == (l_pad, c) and b == 1]
    for t_valid in t_valids:
        plan = tc.lattice_plan(l_pad, c, b, t_valid=t_valid)
        assert _fits_the_card(plan), plan
        assert _holds(plan, tc.longest_feasible(l_pad, t_valid)), plan
        if plan.cluster > tc.PORTABLE_CLUSTER:   # 16 only where 8 cannot hold it
            assert tc.longest_feasible(l_pad, t_valid) + 1 > 8 * 15 * 32
        assert plan == tc.lattice_plan(l_pad, c, b, t_valid=t_valid)
        if plan.cluster == 1:          # a group a candidate, several a block
            assert plan.grid[0] * plan.slots >= c
        else:                          # a cluster a candidate
            assert plan.grid[0] == c * plan.cluster
        assert plan.grid[1] == b


def test_lattice_plan_variant_by_length():
    """One state pair a thread; one warp where the states fit a warp, a
    group of warps where they fit one block (up to 17 warps: the 512 token
    bucket's L + 1 = 513, the champion's 128 and 512), else a cluster of 8
    CTAs (the phoneme rerank's long buckets), 16 where 8 cannot hold the
    candidate; padded rows share blocks: a 512-row chunk at L_pad 128
    takes fewer blocks than rows."""
    assert tc.lattice_plan(31, 512, 1).variant == "warp"
    assert tc.lattice_plan(128, 512, 1).grid == (171, 1)   # 3 groups of 5 warps a block
    for l_pad in (32, 128, 255, 256, 511, 512, 543):
        for c in (2, 64, 512):
            plan = tc.lattice_plan(l_pad, c, 1)
            assert plan.variant == "group" and plan.warps == -(-(l_pad + 1) // 32)
    for l_pad in (544, 1024, 2048, 3072, 3839, 3840, 7679):
        plan = tc.lattice_plan(l_pad, 512, 1)
        assert plan.variant == "cluster"
        assert plan.cluster == (16 if l_pad >= 3840 else 8)
    for l_pad in _BUCKETS:
        plan = tc.lattice_plan(l_pad, 512, 1)
        assert plan.slots == 1 or plan.grid[0] < 512  # fewer blocks where groups share one
    assert tc.lattice_plan(128, 2, 1).grid == (1, 1)     # the tracker's two candidates
    assert tc.lattice_plan(3072, 2, 1).grid == (16, 1)   # a cluster a candidate


def test_lattice_plan_sized_to_the_longest_feasible():
    """With one t_valid for every row, the layout holds (t_valid - 1) // 2
    + 1 state pairs, not L_pad + 1: the champion's L_pad 512 chunk at
    t_valid 304 (L up to 151) runs as groups of 5 warps, as L_pad 128 does,
    and the phoneme bucket 3,072 at t_valid 690 as groups of 11; t_valid 2
    or less leaves one state pair (one warp); an L_pad past every layout
    fits where t_valid bounds the candidates."""
    assert tc.longest_feasible(512, None) == 512
    assert tc.longest_feasible(512, 304) == 151
    assert tc.longest_feasible(128, 304) == 128
    assert tc.longest_feasible(512, 0) == tc.longest_feasible(512, 2) == 0
    assert tc.lattice_plan(512, 512, 1, t_valid=304) == tc.lattice_plan(151, 512, 1)
    assert tc.lattice_plan(512, 512, 1, t_valid=304).warps == 5
    assert tc.lattice_plan(3072, 64, 1, t_valid=690) == tc.lattice_plan(344, 64, 1)
    assert tc.lattice_plan(3072, 64, 1, t_valid=690).variant == "group"
    assert tc.lattice_plan(512, 64, 1, t_valid=2).variant == "warp"
    with pytest.raises(ValueError):
        tc.lattice_plan(8192, 2, 1)
    plan = tc.lattice_plan(8192, 2, 1, t_valid=8192)
    assert plan.variant == "cluster" and _holds(plan, 4095)


@pytest.mark.parametrize("variant", ["warp", "group", "cluster"])
def test_lattice_plan_asked_variant_fits_or_raises(variant):
    """A variant asked for holds every bucket it fits and raises on the
    rest: one warp holds at most 32 state pairs, one block of 17 warps 544,
    a 16-CTA cluster 15 warps of 32 a CTA (one pair a thread)."""
    capacity = {"warp": 32, "group": 544, "cluster": 16 * 15 * 32}[variant]
    for l_pad in _BUCKETS + [543, 544, 7679, 7680]:
        try:
            plan = tc.lattice_plan(l_pad, 64, 2, variant=variant)
        except ValueError:
            assert l_pad + 1 > capacity
            continue
        assert plan.variant == variant and _fits_the_card(plan) and _holds(plan, l_pad)


def test_lattice_plan_raises_where_nothing_fits():
    """Past 16 CTAs x 15 warps (beside each CTA's halo warp), for an empty
    L_pad, a grid of more rows than the card takes, an unknown variant and
    a variant that cannot hold the states; the wrapper raises before it
    launches (a meta tensor: no card here)."""
    tc.lattice_plan(7679, 512, 1)
    for args, kw in (((7680, 512, 1), {}), ((0, 512, 1), {}), ((128, 512, 65536), {}),
                     ((128, 512, 1), {"variant": "block"}),
                     ((128, 512, 1), {"variant": "warp"}),
                     ((9000, 2, 1), {"t_valid": 20000})):
        with pytest.raises(ValueError):
            tc.lattice_plan(*args, **kw)
    lp = torch.empty((64, 70), device="meta")
    with pytest.raises(ValueError, match="does not fit"):
        tc.ctc_forward_scores(lp, 1 << 20,
                              torch.empty((1, 40000), dtype=torch.int32, device="meta"),
                              torch.empty(1, dtype=torch.int32, device="meta"), 69)
    with pytest.raises(ValueError, match="does not fit"):
        tc.ctc_forward_scores_batch(lp[None], torch.tensor([64]),
                                    torch.empty((1, 40000), dtype=torch.int32, device="meta"),
                                    torch.empty(1, dtype=torch.int32, device="meta"), 69)


def _jax_chunks(t_frames, lengths):
    """The JAX package's _score_feasible loop (tilawa_tpu/pipeline/rerank.py)
    over candidates of these sorted lengths: (start, end, L_pad, C_pad)."""
    out, pos = [], 0
    while pos < len(lengths):
        l_pad = jc._next_bucket(max(lengths[pos], 1), jc.TOKEN_BUCKETS)
        c_pad = jr._cand_bucket_for(t_frames, l_pad)
        end = pos
        while end < len(lengths) and end - pos < c_pad and lengths[end] <= l_pad:
            end += 1
        out.append((pos, end, l_pad, c_pad))
        pos = end
    return out


_CHUNK_CASES = [
    (512, [3] * 40 + [90] * 600 + [200] * 30),          # champion rerank: 3 chunks
    (1024, [100] * 100 + [300] * 500),                  # T 1024 x L_pad 512: C 256
    (4096, [60] * 5 + [500] * 300),
    (8192, [700] * 100 + [1500] * 90 + [2598] * 70),    # the phoneme buckets: C 64
    (2048, list(range(1, 2000, 7))),
]


@pytest.mark.parametrize("t_frames,lengths", _CHUNK_CASES)
def test_cpu_route_chunks_equal_the_jax_plan(t_frames, lengths):
    """Where the plain scorer runs (the CPU route, and chip_smoke's plain
    replay on the card) the chunks are JAX's: L-bucketed, C capped by the
    [T, C, L] gather bound (_cand_bucket_for, the same in both packages)."""
    assert tr._chunks(t_frames, lengths, capped=True) == _jax_chunks(t_frames, lengths)
    for l_pad in (128, 512, 1024, 3072):
        assert tr._cand_bucket_for(t_frames, l_pad) == jr._cand_bucket_for(t_frames, l_pad)


@pytest.mark.parametrize("t_frames,lengths", _CHUNK_CASES)
def test_kernel_route_chunks_by_l_bucket_alone(t_frames, lengths):
    """Where the kernel scores, a chunk is one L bucket of up to 512
    candidates, padded to the KERNEL_CAND_BUCKETS bucket of its own count:
    one chunk a bucket while it holds at most 512 candidates (T 1024 /
    L_pad 512 and the phoneme buckets included), never more chunks than the
    capped plan, the same candidates in the same order."""
    chunks = tr._chunks(t_frames, lengths, capped=False)
    buckets = {}
    for n in lengths:
        l_pad = tc._next_bucket(n, tc.TOKEN_BUCKETS)
        buckets[l_pad] = buckets.get(l_pad, 0) + 1
    assert [l for _s, _e, l, _c in chunks] == [
        l for l, n in sorted(buckets.items()) for _ in range(-(-n // 512))]
    assert all(c == tc._next_bucket(e - s, tr.KERNEL_CAND_BUCKETS) and e - s <= c <= 512
               for s, e, _l, c in chunks)
    assert [(s, e) for s, e, _l, _c in chunks][0][0] == 0
    assert all(e == s2 for (_s, e, _l, _c), (s2, *_r) in zip(chunks, chunks[1:]))
    assert chunks[-1][1] == len(lengths)
    assert len(chunks) <= len(tr._chunks(t_frames, lengths, capped=True))
    if t_frames in (1024, 8192):
        assert len(chunks) == len(buckets) < len(tr._chunks(t_frames, lengths, capped=True))


def test_score_token_lists_chunks_by_route(monkeypatch):
    """_score_feasible's own choice: a tensor that is not on the CPU (meta
    here: no card) is chunked by L bucket alone for the kernel, each chunk
    padded to the bucket of its own count; the same call with plain=True
    goes to the plain scorer under the gather cap."""
    calls = []

    def record(name):
        def scorer(lp, t, tokens, lengths, blank):
            calls.append((name, tuple(tokens.shape)))
            return torch.zeros(tokens.shape[0])
        return scorer

    monkeypatch.setattr(tr, "ctc_forward_scores", record("kernel"))
    monkeypatch.setattr(tr, "ctc_forward_scores_plain", record("plain"))
    monkeypatch.setattr(tr, "upload", lambda a, _dev: torch.from_numpy(a))
    lp = torch.empty((1024, 1025), device="meta")
    lists = [[1] * 300] * 300 + [[2] * 100] * 10
    tr.score_token_lists(lp, 1024, lists, blank_id=1024)
    assert calls == [("kernel", (64, 128)), ("kernel", (512, 512))]
    calls.clear()
    tr.score_token_lists(lp, 1024, lists, blank_id=1024, plain=True)
    assert calls == [("plain", (512, 128)), ("plain", (256, 512)), ("plain", (256, 512))]
