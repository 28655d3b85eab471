"""The port's training CTC loss against the JAX package's, on CPU tensors.

On a CPU tensor ops/ctc.py ctc_loss runs its plain versions (the CUDA
kernels of csrc/ctc_loss.cu are held to those on the card by
tests/test_torch_cuda.py and chip_smoke.py). Each case holds the port's
loss and gradient against jax.value_and_grad of the JAX package's
ctc_loss_fn (optax.ctc_loss, mean over rows), taken with respect to its
log_probs input, under a per-row upstream weight where the case has one.

Tolerances: loss rel ≤ 1e-5; gradient max|Δ| ≤ 1e-4 of max|g_jax| in each
row (the same f32 recursion with JAX's logaddexp derivative, exp(a - out),
sums in other orders; on an infeasible row the states sit near -1e5·k,
where an f32 ulp is ~0.01, and the bound holds there too: measured 1.7e-7
on the recorded crop). The plain backward against autograd through
ctc_loss_plain: max|Δ| ≤ 1e-5 of max|g| a row on feasible rows (torch's
logaddexp derivative is another formula, which parts from JAX's on an
infeasible row); gradcheck in f64.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.train import train as jtrain  # noqa: E402
from tilawa_tpu_torch.ops import ctc, kernels  # noqa: E402
from tilawa_tpu_torch.train import train as ttrain  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PORT = Path(__file__).resolve().parent.parent / "tilawa_tpu_torch"


def _log_probs(rng, shape):
    """A model's head output: log_softmax of N(0, 2²) logits (optax
    normalizes it again)."""
    return np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * 2)))


def _labels(rng, lengths, n, v, blank, run_rows=()):
    """[B, n] labels of the given lengths (never the blank), zero-padded;
    rows in run_rows carry a run of one token (repeats)."""
    labels = np.array([c for c in range(v) if c != blank])
    tokens = np.zeros((len(lengths), n), np.int32)
    for r, length in enumerate(lengths):
        ids = rng.choice(labels, size=length)
        if r in run_rows and length > 4:
            ids[1:4] = ids[0]
        tokens[r, :length] = ids
    return tokens, np.asarray(lengths, np.int32)


def _jax(lp, enc, tokens, tlens, blank, weight):
    """Rows of optax.ctc_loss and the gradient of sum_b weight[b]·row[b]
    at lp: jax.value_and_grad of ctc_loss_fn (a mean: weights times B)."""
    b = lp.shape[0]
    w = None if weight is None else jnp.asarray(weight, jnp.float32) * b

    def rows(x):
        return jax.vmap(lambda *r: jtrain.ctc_loss_fn(*(a[None] for a in r), blank))(
            x, jnp.asarray(enc), jnp.asarray(tokens), jnp.asarray(tlens))

    def weighted(x):
        return jtrain.ctc_loss_fn(x, jnp.asarray(enc), jnp.asarray(tokens),
                                  jnp.asarray(tlens), blank) if weight is None else \
            jnp.mean(rows(x) * w)

    loss, grad = jax.value_and_grad(weighted)(jnp.asarray(lp))
    return np.asarray(rows(jnp.asarray(lp))), float(loss), np.asarray(grad)


def _torch(lp, enc, tokens, tlens, blank, weight):
    x = torch.tensor(lp, requires_grad=True)
    rows = ctc.ctc_loss(x, torch.from_numpy(enc), torch.from_numpy(tokens),
                        torch.from_numpy(tlens), blank)
    loss = rows.mean() if weight is None else (rows * torch.from_numpy(
        np.asarray(weight, np.float32))).sum()
    loss.backward()
    return rows.detach().numpy(), float(loss.detach()), x.grad.numpy()


def _hold(lp, enc, tokens, tlens, blank, weight=None):
    """The port's rows, loss and gradient against JAX's; returns the worst
    per-row gradient ratio."""
    kernels.reset_launches()
    rows_j, loss_j, grad_j = _jax(lp, enc, tokens, tlens, blank, weight)
    rows_t, loss_t, grad_t = _torch(lp, enc, tokens, tlens, blank, weight)
    assert kernels.LAUNCHES["ctc_loss"] == 0
    assert np.all(np.isfinite(rows_t))
    np.testing.assert_allclose(rows_t, rows_j, rtol=LOSS_RTOL, atol=0)
    assert abs(loss_t - loss_j) <= LOSS_RTOL * abs(loss_j)
    worst = 0.0
    for r in range(lp.shape[0]):
        top = np.abs(grad_j[r]).max()
        err = np.abs(grad_t[r] - grad_j[r]).max()
        assert err <= GRAD_RTOL * top, (r, err, top)
        worst = max(worst, err / top if top else 0.0)
    t = np.arange(lp.shape[1])[None, :, None]
    assert not np.any(grad_t * (t >= enc[:, None, None])), "a padded frame has a gradient"
    return worst


@pytest.mark.parametrize("v,blank", [(12, 11), (12, 0), (70, 69), (1025, 1024), (1025, 0)])
def test_feasible_rows_with_repeats_and_short_rows(v, blank):
    rng = np.random.default_rng(v + blank)
    b, t = 4, 30
    lp = _log_probs(rng, (b, t, v))
    enc = np.array([30, 25, 18, 9], np.int32)
    tokens, tlens = _labels(rng, [5, 3, 7, 2], 8, v, blank, run_rows=(0, 2))
    tokens[1, :3] = tokens[1, 0]               # a row of one repeated token
    _hold(lp, enc, tokens, tlens, blank)


def test_label_padding_and_empty_labels():
    """L = 0 (the loss is -sum of the blank's log-probs), a row whose last
    label equals the padding value (optax's repeat flag reads the padded
    row), a row that fills the padded width, enc_len 0 and enc_len past T."""
    rng = np.random.default_rng(3)
    v, blank = 9, 8
    lp = _log_probs(rng, (5, 16, v))
    enc = np.array([16, 12, 16, 0, 40], np.int32)
    tokens, tlens = _labels(rng, [0, 3, 6, 2, 4], 6, v, blank)
    tokens[1, 2] = 0                           # == the padding token after it
    _hold(lp, enc, tokens, tlens, blank)


def test_rows_of_different_lengths_with_upstream_weights():
    """Distillation divides each row by its token count; the sharded step
    sums its rows over the global batch: a non-uniform upstream gradient."""
    rng = np.random.default_rng(11)
    v, blank = 70, 69
    lp = _log_probs(rng, (6, 60, v))
    enc = np.array([60, 51, 40, 33, 20, 7], np.int32)
    tokens, tlens = _labels(rng, [22, 3, 17, 12, 1, 2], 24, v, blank, run_rows=(0, 3))
    _hold(lp, enc, tokens, tlens, blank, weight=1.0 / np.maximum(tlens, 1) / 6)
    _hold(lp, enc, tokens, tlens, blank, weight=np.full(6, 1 / 16))


@pytest.fixture(scope="module")
def infeasible_crop():
    """The recorded v1 crop (multi_036_001_005) that random_window_crop and
    the 0.9x speed perturbation make infeasible: its labels need more
    encoder frames than it has (tests/test_torch_train.py finds it)."""
    from tilawa_tpu_torch.train.data import (
        _attach_spans, _augment, load_corpus_examples, random_window_crop)

    raw = [e for e in load_corpus_examples("v1", max_audio_s=160, return_ids=True)
           if e[0] == "multi_036_001_005"]
    (a, ids, spans), = _attach_spans(("v1",), raw)
    rng = np.random.default_rng(39)
    for _ in range(200):
        out, kept = random_window_crop(a, ids, spans, rng, max_len=len(a))
        out = _augment(out, rng, 10**9)
        kept = np.asarray(kept)
        need = len(kept) + int(np.sum(kept[1:] == kept[:-1]))
        t = int(ttrain.encoder_lengths([len(out)])[0])
        if t < need:
            return kept, t
    pytest.fail("no infeasible crop found")


def test_infeasible_crop_matches_optax(infeasible_crop):
    """Row 0 holds the crop's first labels in 8 frames (feasible), row 1
    the whole crop in its own frames (infeasible). There the gradient
    follows JAX's logaddexp derivative, exp(a - out), as the kernel does:
    torch's autograd of the same recursion takes 1 / (1 + exp(b - a)),
    which differs once out is rounded at -1e5 (measured: 2.5e-3 of max|g|)."""
    kept, t = infeasible_crop
    v = 1025
    lp = _log_probs(np.random.default_rng(6), (2, 8, v))
    enc = np.array([8, t], np.int32)
    tokens = np.zeros((2, len(kept) + 2), np.int32)
    tokens[0, :3] = kept[:3]
    tokens[1, :len(kept)] = kept
    tlens = np.array([3, len(kept)], np.int32)
    rows_j, _loss, grad_j = _jax(lp, enc, tokens, tlens, v - 1, None)
    assert rows_j[0] < 1e3 and 1e4 < rows_j[1] < 1e8   # finite: log(0) is -1e5 in optax
    worst = _hold(lp, enc, tokens, tlens, v - 1)
    _hold(lp, enc, tokens, tlens, v - 1, weight=np.array([0.5, 1.0 / len(kept)]))
    x = torch.tensor(lp, requires_grad=True)
    ctc.ctc_loss_plain(x, *map(torch.from_numpy, (enc, tokens, tlens)), v - 1).mean().backward()
    autograd = np.abs(x.grad[1].numpy() - grad_j[1]).max() / np.abs(grad_j[1]).max()
    assert worst < autograd


def test_plain_backward_matches_autograd():
    """On feasible rows (on an infeasible one the two logaddexp derivatives
    part: test_infeasible_crop_matches_optax)."""
    rng = np.random.default_rng(21)
    v, blank = 70, 69
    lp = _log_probs(rng, (4, 24, v))
    enc = np.array([24, 20, 14, 13], np.int32)
    tokens, tlens = _labels(rng, [9, 4, 6, 0], 10, v, blank, run_rows=(0,))
    args = (torch.from_numpy(enc), torch.from_numpy(tokens), torch.from_numpy(tlens), blank)
    weight = torch.tensor([0.3, 1.0, 2.0, 0.7])
    x = torch.tensor(lp, requires_grad=True)
    (ctc.ctc_loss_plain(x, *args) * weight).sum().backward()
    ours = ctc.ctc_loss_grad_plain(torch.tensor(lp), *args, weight)
    for r in range(4):
        top = float(x.grad[r].abs().max())
        assert float((ours[r] - x.grad[r]).abs().max()) <= 1e-5 * top


def test_gradcheck_f64():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((3, 7, 5)), dtype=torch.float64, requires_grad=True)
    enc = torch.tensor([7, 5, 3])
    tokens = torch.tensor([[1, 1, 2], [3, 0, 0], [2, 4, 0]])
    tlens = torch.tensor([3, 1, 2])
    assert torch.autograd.gradcheck(
        lambda a: ctc.ctc_loss(a, enc, tokens, tlens, 0), (x,), eps=1e-6, atol=1e-6)


def test_train_paths_call_the_op():
    """ctc_losses takes host arrays and tensors alike and is the op; on a
    CPU tensor the op is ctc_loss_plain; the op runs under inference_mode
    (train/fit_report.py)."""
    rng = np.random.default_rng(8)
    lp = torch.tensor(_log_probs(rng, (3, 12, 10)))
    enc, tlens = np.array([12, 9, 4], np.int32), np.array([3, 2, 5], np.int32)
    tokens, _ = _labels(rng, [3, 2, 5], 6, 10, 9)
    ref = ctc.ctc_loss(lp, *map(torch.from_numpy, (enc, tokens, tlens)), 9)
    assert torch.equal(ttrain.ctc_losses(lp, enc, tokens, tlens, 9), ref)
    assert torch.equal(ctc.ctc_loss_plain(lp, *map(torch.from_numpy, (enc, tokens, tlens)), 9),
                       ref)
    with torch.inference_mode():
        assert torch.equal(ttrain.ctc_losses(lp, torch.from_numpy(enc), tokens, tlens, 9), ref)
    assert float(ref[2]) > 1e4                 # 5 labels in 4 frames: optax's finite loss
    assert "ctc_loss" in kernels.KERNELS


class _Sharded:
    """Stands for a DTensor: the op reads plain memory only."""

    def to_local(self):
        raise AssertionError("not called")


def test_op_raises_on_what_it_does_not_take():
    x = torch.zeros(2, 5, 4)
    enc, tokens, tlens = torch.tensor([5, 5]), torch.ones(2, 3, dtype=torch.int32), \
        torch.tensor([3, 3])
    with pytest.raises(TypeError, match="DTensor"):
        ctc.ctc_loss(_Sharded(), enc, tokens, tlens, 3)
    with pytest.raises(ValueError, match=r"\[B, T, V\]"):
        ctc.ctc_loss(x[0], enc, tokens, tlens, 3)
    with pytest.raises(ValueError, match=r"\[B\]"):
        ctc.ctc_loss(x, enc[:1], tokens, tlens, 3)


def test_no_port_file_calls_torch_ctc_loss():
    """The port trains through its own op: no F.ctc_loss call anywhere in
    the package (chip_smoke.py times it as a yardstick only)."""
    calls = []
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "ctc_loss" and not (
                        isinstance(node.func.value, ast.Name) and node.func.value.id == "ctc"):
                calls.append(f"{path.relative_to(PORT)}:{node.lineno}")
    assert not calls, calls


@pytest.mark.parametrize("case", __import__("chip_smoke").CTC_LOSS_CASES,
                         ids=[c[0] for c in __import__("chip_smoke").CTC_LOSS_CASES])
def test_training_shapes_fit_one_block(case):
    """Every training bucket's labels (chip_smoke.CTC_LOSS_CASES: v1's
    longest, text and phonemes, and a phoneme row past 1,023 labels) have a
    layout within the card's limits (a block of at most 1,024 threads, a
    cluster of at most 16 CTAs, the grid) that holds their N + 1 state
    pairs, one a thread; the vocabulary fits the epilogue; the plan is a
    pure function of (N, B)."""
    _label, b, _t, v, l_pad, l_max = case
    assert l_max <= l_pad <= ctc.CTC_LOSS_MAX_LABELS
    assert v <= ctc.CTC_LOSS_MAX_VOCAB
    plan = ctc.loss_plan(l_pad, b)
    assert plan == ctc.loss_plan(l_pad, b)
    _fits_the_card(plan, l_pad, b)
    if l_pad > 1023:
        assert plan.variant == "cluster"


def _fits_the_card(plan, n_pad, b):
    """The plan's blocks, clusters and grid are within the H100's limits,
    and its threads hold the N + 1 state pairs."""
    assert 1 <= plan.warps and 32 * plan.warps <= min(1024, ctc.LOSS_MAX_THREADS)
    assert plan.cluster in (1, *ctc.LOSS_CLUSTERS) and plan.cluster <= 16
    assert plan.grid == b * plan.cluster and plan.grid < 2**31
    if plan.cluster == 1:
        assert 32 * plan.warps >= n_pad + 1
        assert plan.variant != "warp" or (plan.warps == 1 and n_pad + 1 <= 32)
    else:
        # each CTA a slice of whole warps, the halo warp beside it
        slice_ = 32 * (plan.warps - 1)
        assert plan.variant == "cluster" and slice_ >= ctc.LOSS_HALO
        assert plan.cluster * slice_ >= n_pad + 1


@pytest.mark.parametrize("n_pad,b", [(0, 1), (31, 16), (32, 16), (255, 1), (256, 1),
                                     (511, 2), (1023, 1), (1536, 2), (2047, 1), (4095, 3),
                                     (ctc.CTC_LOSS_MAX_LABELS, 1)])
def test_loss_plan_forced_variants(n_pad, b):
    """Each variant that holds N + 1 state pairs gives a plan within the
    card's limits, and the same plan for the same arguments; one that
    cannot hold them raises: one warp past 32 states, one block past 512
    threads, a cluster past its CTAs' slices."""
    states = n_pad + 1
    for variant, cluster in [("warp", None), ("group", None)] + [
            ("cluster", c) for c in (None, *ctc.LOSS_CLUSTERS)]:
        holds = {"warp": states <= 32, "group": states <= 512}.get(
            variant, 32 + max(32, 32 * -(-(-(-states // (cluster or 16))) // 32)) <= 512)
        if not holds:
            with pytest.raises(ValueError, match="do not fit"):
                ctc.loss_plan(n_pad, b, variant=variant, cluster=cluster)
            continue
        plan = ctc.loss_plan(n_pad, b, variant=variant, cluster=cluster)
        assert plan == ctc.loss_plan(n_pad, b, variant=variant, cluster=cluster)
        assert plan.variant == variant and (cluster is None or plan.cluster == cluster)
        _fits_the_card(plan, n_pad, b)


def test_loss_plan_default_and_limits():
    """The default layout: one warp up to 32 state pairs, one block up to
    LOSS_GROUP_WARPS warps, a cluster past that and past one block, of 16
    CTAs while B rows' CTAs fit one an SM, else of fewer; past
    CTC_LOSS_MAX_LABELS nothing holds the row; a wrong variant or size
    raises."""
    assert ctc.loss_plan(31, 16).variant == "warp"
    assert ctc.loss_plan(32, 16).variant == "group"
    assert ctc.loss_plan(32 * ctc.LOSS_GROUP_WARPS - 1, 1).variant == "group"
    assert ctc.loss_plan(32 * ctc.LOSS_GROUP_WARPS, 1).variant == "cluster"
    assert ctc.loss_plan(1024, 1).variant == "cluster"
    assert ctc.loss_plan(1024, 2).cluster == 16 and ctc.loss_plan(1024, 16).cluster == 8
    assert ctc.loss_plan(1024, 200).cluster == 4      # the smallest that holds 1,025 states
    with pytest.raises(ValueError, match="do not fit"):
        ctc.loss_plan(ctc.CTC_LOSS_MAX_LABELS + 1, 1)
    with pytest.raises(ValueError, match="no variant"):
        ctc.loss_plan(10, 1, variant="grid")
    with pytest.raises(ValueError, match="do not fit a cluster of 3"):
        ctc.loss_plan(100, 1, variant="cluster", cluster=3)
    with pytest.raises(ValueError, match="rows"):
        ctc.loss_plan(10, 70000)


def _aligned_log_probs(rng, tokens, tlens, t, v, blank):
    """A trained head's output for these labels: N(0, 2²) logits plus 10 on
    label k over frames [k t / L, (k + 1) t / L) of each row (the blank on a
    frame that starts a repeat's second label, as an alignment needs),
    log_softmax."""
    logits = rng.standard_normal((len(tokens), t, v)).astype(np.float32) * 2
    for r, (row, n) in enumerate(zip(tokens, tlens)):
        for k in range(n):
            lo, hi = k * t // n, (k + 1) * t // n
            logits[r, lo:hi, row[k]] += 10
            if k and row[k] == row[k - 1]:
                logits[r, lo, row[k]] -= 10
                logits[r, lo, blank] += 10
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))


def test_rows_past_1023_labels_match_optax():
    """Two phoneme rows (V 70) past one block's 1,023 labels against 1,300
    frames: 1,030 labels in all 1,300 frames (feasible) and 1,200 in 1,150
    (infeasible: optax's finite loss), with repeats; the same tolerances.
    The log-probs are a trained head's (_aligned_log_probs): under random
    ones a 1,300-frame row's log-likelihood is thousands of nats (about
    log V a frame), where an f32 ulp is some 5e-4, so each weight
    exp(a - out) of the adjoint recursion carries that much rounding in JAX
    and in the port alike, more than the gradient's bound allows between
    two orders of the same sums."""
    rng = np.random.default_rng(1030)
    v, blank = 70, 69
    enc = np.array([1300, 1150], np.int32)
    tokens, tlens = _labels(rng, [1030, 1200], 1200, v, blank, run_rows=(0, 1))
    need = [n + int(np.sum(r[1:n] == r[:n - 1])) for r, n in zip(tokens, tlens)]
    assert need[0] <= enc[0] and need[1] > enc[1]
    lp = _aligned_log_probs(rng, tokens, tlens, 1300, v, blank)
    rows, _loss, _grad = _jax(lp, enc, tokens, tlens, blank, None)
    assert rows[0] < 1e3 and rows[1] > 1e5       # feasible; optax's finite infeasible loss
    _hold(lp, enc, tokens, tlens, blank)
