"""The port's multi-device step (tilawa_tpu_torch/parallel/) on the CPU.

One 8-rank gloo job (data 4 x model 2, tests/torch_parallel_cases.py) runs
once for the module and writes every case's result; the tests hold them to
the single-process port and to the JAX package, run live here.

Tolerances (f32 compute):
  * sharded against single-process steps (two steps, one batch of 8 rows,
    the same step generators; dropout 0.1 and 0, live and frozen
    BatchNorm): loss rel ≤ 1e-6; each step's reduced gradient, and AdamW's
    moments after the two steps, by test_torch_train.py's leaf rule at
    GRAD_RTOL (1e-4 of a leaf's own max where that is at least GRAD_FLOOR
    of the largest, else of the largest); BatchNorm running stats ≤ 1e-6.
    Measured: loss 9.1e-8 rel, moments ≤ 2.6e-5 of their own max — the
    single-process step with its batch rows reversed (the same sums in
    another order, dropout 0) moves its loss by the same 9.1e-8.
  * the updated parameters: the sharded run's gradients replayed through
    a single-process optimizer from the same init give its parameters and
    moments to 1e-6·max|p| (and of max|moment|). Against the independent
    single-process run an element is not held that close: AdamW divides
    each element's step by that element's own gradient, so where the
    gradient is rounding noise (the key bias; the depthwise conv bias under
    batch statistics) two runs that order their sums differently step by
    up to ±lr: the single-process run against itself with reversed rows
    moves blocks.1.conv.dw.bias by 1.1e-4 after two steps (lr 3e-4).
  * the JAX package's unsharded step (JAX-made variables, dropout 0): loss
    rel ≤ 1e-5, gradients by assert_grads_match, new running stats ≤ 1e-6,
    as tests/test_torch_train.py holds the single-process port.
  * sharded inference scores against the unsharded forward's: the same
    infinities, finite scores within 1e-5·max|score| (partial products
    summed over "model" in another order).
"""

import math
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import torch_parallel_cases as cases
from test_torch_train import assert_grads_match, _jax_step, _np
from tilawa_tpu.models import fastconformer as jfc
from tilawa_tpu.ops import ctc as jctc
from tilawa_tpu.parallel.sharding import param_spec as jax_param_spec
from tilawa_tpu.train import train as jtrain
from tilawa_tpu.train.checkpoint import load_variables as jax_load_variables
from tilawa_tpu.train.quantize import dequantize_variables as jax_dequantize
from tilawa_tpu_torch.models import fastconformer as tfc
from tilawa_tpu_torch.models.convert import params_from_jax
from tilawa_tpu_torch.ops.ctc import ctc_forward_scores_batch
from tilawa_tpu_torch.parallel import dryrun
from tilawa_tpu_torch.parallel.mesh import init_distributed, make_mesh
from tilawa_tpu_torch.train import train as ttrain
from tilawa_tpu_torch.train.checkpoint import load_variables

REPO = Path(__file__).resolve().parent.parent
CASE_IDS = [f"dropout{d}-{'frozen' if f else 'live'}-bn" for d, f in cases.CASES]
LOSS_RTOL = 1e-6
STAT_TOL = 1e-6
PARAM_RTOL = 1e-6
SCORE_RTOL = 1e-5


def _jax_config():
    return jfc.FastConformerConfig.small(num_heads=4, d_model=64, dropout=0.0, use_pallas=False)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX-made variables of the dry run's config (tilawa_tpu
    train.py init_state), then the 8-rank job over them."""
    out = tmp_path_factory.mktemp("mesh")
    _model, state = jtrain.init_state(_jax_config(), jtrain.make_optimizer(total_steps=10),
                                      example_samples=8000)
    variables = _np({"params": state.params, "batch_stats": state.batch_stats})
    torch.save(params_from_jax(variables), out / "jax_state.pt")
    run = subprocess.run([sys.executable, str(Path(cases.__file__)), str(out)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return SimpleNamespace(out=out, variables=variables,
                           results=torch.load(out / "results.pt", weights_only=False))


def _single_process(dropout, freeze_bn):
    """cases.STEPS single-process steps as the job's: losses, each step's
    gradient (before the clip), the model and its optimizer."""
    model = ttrain.init_state(cases.config(dropout), device="cpu")
    opt = cases.optimizer(model)
    grads = cases._recording_grads(model, opt)
    step_fn = ttrain.make_train_step(model.cfg.blank_id, freeze_bn=freeze_bn)
    state, b = ttrain.TrainState(model, opt), cases.batch()
    losses = [float(step_fn(state, b, ttrain.step_generator(0, i, torch.device("cpu"))))
              for i in range(cases.STEPS)]
    return losses, grads, model, opt


def _as_grads(tree: dict) -> dict:
    return {k: SimpleNamespace(grad=v) for k, v in tree.items()}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _jax_placements(variables: dict) -> dict:
    """tilawa_tpu param_spec of every leaf by the port's state-dict key:
    scan-stacked block leaves with their leading axis dropped, batch_stats
    replicated (variables_shardings), translated to (data, model)
    placements: P(None, "model") -> Shard(1), P("model", None) -> Shard(0),
    P() -> Replicate()."""
    out = {}
    for collection, tree in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = tuple(p.key for p in path)
            stacked = names[0] == "blocks"
            ndim = np.ndim(leaf) - stacked
            spec = tuple(jax_param_spec(names, ndim)) if collection == "params" else ()
            placements = tuple(
                f"Shard(dim={spec.index(axis)})" if axis in spec else "Replicate()"
                for axis in ("data", "model"))
            keys = [".".join(("blocks", str(i)) + names[2:]) for i in range(np.shape(leaf)[0])] \
                if stacked else [".".join(names)]
            out.update({k: placements for k in keys})
    return out


@pytest.mark.parametrize("which", ["dryrun", "champion"])
def test_placements_match_jax_param_spec(job, which):
    """Every variable's placement is the JAX package's param_spec translated,
    for the dry run's model and the champion's dequantized tree; the dry
    run's DTensors carry those placements."""
    if which == "dryrun":
        variables = job.variables
    else:
        variables = _np(jax_dequantize(jax_load_variables(REPO / "exports" / "champion-int4")[1]))
    want = _jax_placements(variables)
    got = job.results["placements"][which]
    assert got == want
    assert {"Shard(dim=0)", "Shard(dim=1)"} <= {p[1] for p in got.values()}
    if which == "dryrun":
        assert job.results["placements"]["dryrun_placed"] == got
        data, rep = ("Shard(dim=0)", "Replicate()"), ("Replicate()", "Replicate()")
        assert job.results["placements"]["inputs"] == {
            "data_sharding": data, "replicated": rep, "data_batch_spec": data,
            "batch": ("(Shard(dim=0), Replicate())", "(Replicate(), Replicate())")}


@pytest.mark.parametrize("case", cases.CASES, ids=CASE_IDS)
def test_sharded_steps_match_single_process(job, case):
    """Two sharded steps against two single-process steps: losses,
    gradients, BatchNorm stats and AdamW moments; every rank's replicated
    variables bitwise equal (no drift) and its losses the same; the
    layers' plain rank_parts still on the DTensors' storage."""
    got = job.results["steps"][case]
    losses, grads, model, opt = _single_process(*case)
    for ours, ref in zip(got["losses"], losses):
        assert _rel(ours, ref) <= LOSS_RTOL
    for ours, ref in zip(got["grads"], grads):
        assert_grads_match(ref, _as_grads(ours))
    state = model.state_dict()
    for name, ref in state.items():
        if name.endswith((".mean", ".var")):
            assert float((got["state"][name] - ref).abs().max()) <= STAT_TOL, name
    names = cases._names(model)
    for k in ("exp_avg", "exp_avg_sq"):
        ref = {names[id(p)]: opt.adamw.state[p][k] for p in opt.params}
        assert_grads_match(ref, _as_grads({n: got["moments"][f"{n}.{k}"] for n in ref}))
    assert got["moments_placed"] and got["rank_parts"]
    for other in job.results["others"]:
        assert other["digests"][case] == got["digest"]
        assert other["losses"][case] == got["losses"]


@pytest.mark.parametrize("case", cases.CASES, ids=CASE_IDS)
def test_optimizer_replay_gives_the_sharded_parameters(job, case):
    """The sharded run's own reduced gradients through a single-process
    optimizer from the same init: every updated parameter (gathered) and
    moment of the sharded run, to 1e-6 of the leaf's max."""
    got = job.results["steps"][case]
    model = ttrain.init_state(cases.config(case[0]), device="cpu")
    opt = cases.optimizer(model)
    params = dict(model.named_parameters())
    for grads in got["grads"]:
        for name, p in params.items():
            p.grad = grads[name].clone()
        opt.step()
    names = cases._names(model)
    for name, p in params.items():
        assert float((p.detach() - got["state"][name]).abs().max()) <= \
            PARAM_RTOL * float(p.detach().abs().max()), name
    for p in opt.params:
        for k in ("exp_avg", "exp_avg_sq"):
            ref = opt.adamw.state[p][k]
            assert float((ref - got["moments"][f"{names[id(p)]}.{k}"]).abs().max()) <= \
                PARAM_RTOL * float(ref.abs().max()), (names[id(p)], k)


@pytest.mark.parametrize("freeze_bn", [False, True], ids=["live-bn", "frozen-bn"])
def test_sharded_step_matches_jax(job, freeze_bn):
    """One sharded step from the JAX-made variables at dropout 0 against
    jax.value_and_grad of the JAX package's unsharded step."""
    loss_j, grads_j, bs_j = _jax_step(_jax_config(), job.variables, cases.batch(), freeze_bn)
    got = job.results["jax"][freeze_bn]
    assert np.isfinite(loss_j) and _rel(got["loss"], loss_j) <= 1e-5
    ref = params_from_jax({"params": grads_j})
    assert ref.keys() == got["grads"].keys()
    assert_grads_match(ref, _as_grads(got["grads"]))
    for name, stat in params_from_jax({"batch_stats": bs_j}).items():
        assert float((got["stats"][name] - stat).abs().max()) <= STAT_TOL, name


@pytest.mark.parametrize("rows", [4, 8])
def test_sharded_inference_matches_unsharded(job, rows):
    """The dp/tp-sharded forward and CTC rerank of 6 candidates, gathered
    to (B, 6), against the unsharded model's; the row-by-row attention
    products (B = 8: two rows a data rank) saw plain tensors only."""
    got = job.results["inference"][f"scores_{rows}"]
    model = tfc.FastConformerCTC(cases.config(0.0))
    model.load_state_dict(torch.load(job.out / "jax_state.pt"), strict=True)
    b = cases.batch()
    ref = dryrun.recognize_scores(model, b[0][:rows], b[1][:rows], *dryrun.rerank_candidates())
    assert got.shape == ref.shape == (rows, 6)
    finite = torch.isfinite(ref)
    assert torch.equal(finite, torch.isfinite(got)) and finite.any()
    assert float((got[finite] - ref[finite]).abs().max()) <= \
        SCORE_RTOL * float(ref[finite].abs().max())
    calls = job.results["inference"]["row_matmul_calls"]
    assert {t for _b, *ts in calls for t in ts} == {"Tensor"}
    assert {b for b, *_ in calls} == {1, 2}
    for other in job.results["others"]:
        assert torch.equal(other["scores"], job.results["inference"]["scores_8"])


def test_train_with_a_mesh_equals_train(job, tmp_path):
    """train(..., mesh=...) against train() without one: the loss history;
    rank 0's checkpoint holds the gathered full variables."""
    got = job.results["train"]
    _model, _state, history = ttrain.train(
        cases.config(0.1), iter([cases.batch()] * cases.STEPS), cases.STEPS, seed=0,
        log_every=1, warmup_steps=1, device="cpu")
    assert len(got["history"]) == len(history) == cases.STEPS
    for ours, ref in zip(got["history"], history):
        assert _rel(ours, ref) <= LOSS_RTOL
    config, variables = load_variables(job.out / "mesh_run" / f"step_{cases.STEPS:06d}")
    assert config == cases.config(0.1)
    saved = params_from_jax(variables)
    assert saved.keys() == got["state"].keys()
    assert all(torch.equal(saved[k], got["state"][k]) for k in saved)


def test_kernel_wrappers_raise_on_a_dtensor(job):
    guards = job.results["guards"]
    assert guards and all(e is not None and e.startswith("TypeError") and "DTensor" in e
                          for e in guards.values()), guards


def test_ctc_forward_scores_batch_matches_jax():
    """[B, C] scores against the JAX package's vmapped scorer on seeded
    inputs: rows of 12, 7 and 3 valid frames; candidates of 1, 3, 5 labels
    (with repeats) and an empty one. Infeasible pairs (2L+1 > t_valid, or
    L = 0) are +inf in both; the rest within 1e-5 relative."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 12, 6)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    t_valid = np.array([12, 7, 3], np.int32)
    tokens = np.array([[2, 0, 0, 0, 0], [1, 1, 3, 0, 0], [4, 2, 2, 1, 3], [0, 0, 0, 0, 0]],
                      np.int32)
    lengths = np.array([1, 3, 5, 0], np.int32)
    ref = np.asarray(jctc.ctc_forward_scores_batch(lp, t_valid, tokens, lengths, 5))
    got = ctc_forward_scores_batch(torch.from_numpy(lp), torch.from_numpy(t_valid),
                                   torch.from_numpy(tokens), torch.from_numpy(lengths), 5).numpy()
    assert got.shape == ref.shape == (3, 4)
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    assert np.isinf(ref).any() and np.isfinite(ref).any()
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-5)


def test_cli_dry_run_prints_the_jax_line():
    """python -m tilawa_tpu_torch.parallel.dryrun --device cpu --devices 8:
    8 gloo ranks, the JAX package's line with a real (finite, unclamped)
    loss."""
    out = subprocess.run(
        [sys.executable, "-m", "tilawa_tpu_torch.parallel.dryrun", "--device", "cpu",
         "--devices", "8"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    m = re.fullmatch(
        r"dryrun_multichip ok: 8 devices, mesh \{'data': 4, 'model': 2\}, 1 train step "
        r"\(loss (\S+)\) \+ 1 dp/tp-sharded inference\+rerank dispatch \(scores \(4, 6\)\)",
        out.stdout.strip().splitlines()[-1])
    assert m, out.stdout
    loss = float(m.group(1))
    assert math.isfinite(loss) and loss < 1e4


def test_make_mesh_and_init_raise():
    """A non-divisible model axis is a ValueError, as in the JAX package; a
    cuda mesh or process group where CUDA is absent raises rather than
    carry on on the CPU."""
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(8, model_parallel=3, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA errors cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("cuda", 0, 1, "file:///nonexistent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.spawn(dryrun.entry, 1, "cuda")


def test_entry_is_the_large_forward():
    """entry(): the large config's forward on zero variables and 4 s of
    silence gives [1, T, 1025] log-probs, finite, and T frames."""
    forward, (model, audio, lengths) = dryrun.entry(device="cpu")
    assert model.cfg == tfc.FastConformerConfig.large()
    with torch.no_grad():
        lp, enc = forward(model, audio, lengths)
    assert lp.shape == (1, int(enc[0]), 1025) and torch.isfinite(lp).all()
