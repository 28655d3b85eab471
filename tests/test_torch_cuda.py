"""The hand-written CUDA kernels on the card (marker `gpu`; skipped where
torch.cuda.is_available() is false). Run on a CUDA machine with
`python -m pytest tests/test_torch_cuda.py -m gpu --noconftest` (the
repository conftest imports jax, which a CUDA machine may lack).

Tolerances: int4 and int8_matmul (scale in W), max|Δ| ≤ 1e-5·max|ref|
(same bf16 operands, f32 sums in another order; a W left unrounded to bf16
errs by ~1e-3·max|ref|); int8_dense (scale after, bf16 out), each element
within two bf16 ulps (2^-6·|ref|) plus 1e-5·max|ref| for sums that cancel,
and under 1% of the elements different (the bf16 rounding of an f32 sum
taken in another order flips its last bit, and the scale multiply can
widen that flip to two ulps of the output); log-mel, 2e-3 (the kernel's
radix-4 FFT vs cuFFT's rfft in f32, sums in other orders; the bound
tests/test_frontend.py holds the JAX fused kernel to), silence within
1e-6 of ln(1e-5), frames bitwise independent of B and offset. Fused
layer epilogues with a bias (int4_dense, int8_dense): each element within
two bf16 ulps of the pre-bias value plus two of the output, 2^-6·(|u| +
|ref|), plus 1e-5·max|ref|, under 1% of the elements different (the bias
add can carry a last-bit flip of the rounded product one output ulp
further); int4_dense is also bit-equal to the cast and bias add of
int4_matmul's own f32 output (same body, same sum order). Row invariance:
bitwise. The streaming cache against forward_long on stream6-int8: 1e-5,
the reference's contract (tests/test_runtime_long.py). A full-width
training step (f32 compute) with the log-mel kernel against the plain
log-mel: within the deltas that ±2e-3 noise on the plain log-mel gives the
same step (chip_smoke.train_vs_plain). The CTC lattice against its plain
version (the same f32 logaddexp recursion, IEEE expf/log1pf in the same
order): equal +inf patterns, finite scores within rtol/atol 1e-5, and the
same best candidate (argmin) a call; each of its variants (one warp, warp
group, cluster) also bitwise (`-k lattice`). The training CTC loss
(`-k ctc_loss`) against its plain version: each row's loss within rel
1e-5 (bitwise under every layout loss_plan accepts) and its gradient
within 1e-4 of its plain max|g| (the same f32 recursion with IEEE
expf/log1pf in the same order, the sums of the softmax and of the
posteriors in other orders), two runs and a CUDA-graph replay bitwise
equal. The f32 training step run twice: bitwise equal."""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tilawa_tpu_torch.ops import ctc, frontend, kernels, quant  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [
    (50, 2560, 512), (99, 512, 512), (50, 512, 1024), (400, 512, 2048),
    (50, 2048, 512), (50, 512, 1025), (1, 32, 3), (37, 64, 130),
])
def test_int4_kernel_matches_plain(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    packed, scales = quant.pack_int4(rng.standard_normal((k, n)).astype(np.float32))
    packed, scales = torch.from_numpy(packed).to(cuda), torch.from_numpy(scales).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    kernels.reset_launches()
    out = quant.int4_matmul(x, packed, scales)
    ref = quant.int4_matmul_plain(x, packed, scales)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int4_matmul"] == 1
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_int4_kernel_rejects_bad_inputs(cuda):
    packed = torch.zeros((32, 8), dtype=torch.uint8, device=cuda)
    scales = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError):
        quant.int4_matmul(torch.zeros((2, 66), device=cuda), packed, scales)
    with pytest.raises(TypeError):
        quant.int4_matmul(torch.zeros((2, 64), device=cuda), packed.float(), scales)


# (B, N) the paths launch: forward's buckets, the TTA pair, forward_long's
# and the cache's padded batches, a ragged N; and the three first cases
LOG_MEL_SHAPES = [
    (2, 64000), (1, 12345), (3, 400), (1, 64000), (1, 128000), (1, 256000),
    (1, 512000), (2, 256000), (8, 256000),
]


def _pre(cuda, b, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32)).to(cuda)


@pytest.mark.parametrize("b,n", LOG_MEL_SHAPES)
def test_log_mel_kernel_matches_plain(cuda, b, n):
    pre = _pre(cuda, b, n, n)
    tables = frontend.mel_tables(cuda)
    kernels.reset_launches()
    out = frontend.fused_log_mel(pre, tables)
    ref = frontend.log_mel_plain(pre, tables)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["log_mel"] == 1
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 2e-3


def test_log_mel_frame_does_not_depend_on_batch_or_offset(cuda):
    """A frame's log-mels are bitwise a function of its 400 samples alone:
    each row of a B=3 batch equals the row launched alone, and the frames
    of pre[:, 160 j:] equal frames j.. of pre, for offsets that move a
    frame to every place in a block."""
    pre = _pre(cuda, 3, 64000, 11)
    tables = frontend.mel_tables(cuda)
    full = frontend.fused_log_mel(pre, tables)
    for b in range(3):
        alone = frontend.fused_log_mel(pre[b:b + 1].contiguous(), tables)
        assert torch.equal(alone.view(torch.int32), full[b:b + 1].view(torch.int32))
    for j in (1, 2, 3, 5, 97):
        shifted = frontend.fused_log_mel(pre[:, 160 * j:].contiguous(), tables)
        assert torch.equal(shifted.view(torch.int32), full[:, j:].view(torch.int32))


def test_log_mel_of_silence_is_the_log_guard(cuda):
    pre = torch.zeros((2, 16000), device=cuda)
    tables = frontend.mel_tables(cuda)
    out = frontend.fused_log_mel(pre, tables)
    ref = frontend.log_mel_plain(pre, tables)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-6
    assert float((out - np.log(np.float32(1e-5))).abs().max()) <= 1e-6


def test_log_mel_kernel_rejects_bad_inputs(cuda):
    tables = frontend.mel_tables(cuda)
    with pytest.raises(ValueError):
        frontend.fused_log_mel(torch.zeros((2, 8000), dtype=torch.float64, device=cuda), tables)
    with pytest.raises(ValueError):
        frontend.fused_log_mel(torch.zeros((8000,), device=cuda), tables)
    with pytest.raises(ValueError):
        frontend.fused_log_mel(torch.zeros((1, 8000), device=cuda),
                               tables._replace(bands=tables.bands.float()))


def test_champion_kernel_path_matches_plain_path(cuda):
    from tilawa_tpu_torch.io.bundle import EXPORTS_DIR, load_variables
    from tilawa_tpu_torch.ops.ctc import collapse_ctc
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime
    from tilawa_tpu_torch.data.audio import load_audio

    config, variables = load_variables(EXPORTS_DIR / "champion-int4")
    audio = load_audio(EXPORTS_DIR.parent / "benchmark" / "test_corpus" / "retasy_003.wav")
    kernel_rt = EncoderRuntime(config, variables, cuda)
    plain_rt = EncoderRuntime(dataclasses.replace(config, use_pallas=False), variables, cuda)
    kernels.reset_launches()
    _lp, ids_k, t_k = kernel_rt.forward(audio)
    assert kernels.LAUNCHES == {"int4_matmul": 189, "log_mel": 1, "int8_matmul": 0,
                               "ctc_lattice": 0, "ctc_loss": 0}
    _lp, ids_p, t_p = plain_rt.forward(audio)
    assert kernels.LAUNCHES == {"int4_matmul": 189, "log_mel": 1, "int8_matmul": 0,
                               "ctc_lattice": 0, "ctc_loss": 0}
    assert t_k == t_p
    assert collapse_ctc(ids_k, 1024) == collapse_ctc(ids_p, 1024)


INT8_SHAPES = [
    (50, 2560, 512), (99, 512, 512), (50, 512, 1024), (400, 512, 2048),
    (50, 2048, 512), (50, 512, 1025), (1, 32, 3), (37, 64, 130), (5, 36, 48),
]


def _int8_case(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    q, scales = quant.quantize_int8((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    return x, torch.from_numpy(q).to(cuda), torch.from_numpy(scales).to(cuda)


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n):
    x, q, scales = _int8_case(cuda, m, k, n)
    kernels.reset_launches()
    out = quant.int8_matmul(x, q, scales)
    ref = quant.int8_matmul_plain(x, q, scales)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int8_matmul"] == 1
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_dense_kernel_matches_plain(cuda, m, k, n):
    x, q, scales = _int8_case(cuda, m, k, n)
    kernels.reset_launches()
    out = quant.int8_dense(x, q, scales)
    ref = quant.int8_dense_plain(x, q, scales)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int8_matmul"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    delta = (out.float() - ref.float()).abs()
    bound = 2.0 ** -6 * ref.float().abs() + 1e-5 * float(ref.float().abs().max())
    assert bool((delta <= bound).all())
    assert float((delta > 0).float().mean()) < 1e-2


def test_int8_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros((64, 8), dtype=torch.int8, device=cuda)
    scales = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        quant.int8_dense(torch.zeros((2, 66), device=cuda), q, scales)
    with pytest.raises(TypeError):
        quant.int8_matmul(torch.zeros((2, 64), device=cuda), q.float(), scales)


def test_stream6_kernel_path_matches_plain_path(cuda):
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.io.bundle import EXPORTS_DIR, load_variables
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime
    from tilawa_tpu_torch.ops.ctc import collapse_ctc

    config, variables = load_variables(EXPORTS_DIR / "stream6-int8")
    audio = load_audio(EXPORTS_DIR.parent / "benchmark" / "test_corpus" / "retasy_003.wav")
    kernel_rt = EncoderRuntime(config, variables, cuda)
    plain_rt = EncoderRuntime(dataclasses.replace(config, use_pallas=False), variables, cuda)
    kernels.reset_launches()
    _lp, ids_k, t_k = kernel_rt.forward(audio)
    assert kernels.LAUNCHES == {"int4_matmul": 0, "log_mel": 1, "int8_matmul": 189,
                               "ctc_lattice": 0, "ctc_loss": 0}
    _lp, ids_p, t_p = plain_rt.forward(audio)
    assert kernels.LAUNCHES == {"int4_matmul": 0, "log_mel": 1, "int8_matmul": 189,
                               "ctc_lattice": 0, "ctc_loss": 0}
    assert t_k == t_p
    assert collapse_ctc(ids_k, 1024) == collapse_ctc(ids_p, 1024)


# (K, N) of every product the paths launch and the rows M they run at
# (chip_smoke.py INT4_SHAPES; pos at the 2T-1 relative positions)
PATH_SHAPES = [(2560, 512), (512, 512), (512, 1024), (512, 2048), (2048, 512), (512, 1025)]
PATH_MS = (1, 50, 100, 200, 400)
POS_MS = (1, 99, 199, 399, 799)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _layer_case(cuda, kind, k, n, m, seed):
    """(quantized-matmul function of x, x [m, K] bf16) for one path shape."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    if kind.startswith("int4"):
        packed, scales = (torch.from_numpy(a).to(cuda) for a in quant.pack_int4(w))
        if kind == "int4_matmul":
            return (lambda v: quant.int4_matmul(v, packed, scales)), x.to(torch.bfloat16)
        return (lambda v: quant.int4_dense(v, packed, scales, bias)), x.to(torch.bfloat16)
    q, scales = (torch.from_numpy(a).to(cuda) for a in quant.quantize_int8(w))
    if kind == "int8_matmul":
        return (lambda v: quant.int8_matmul(v, q, scales)), x.to(torch.bfloat16)
    return (lambda v: quant.int8_dense(v, q, scales, bias)), x.to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["int4_matmul", "int4_dense", "int8_matmul", "int8_dense"])
@pytest.mark.parametrize("k,n,ms", [(k, n, PATH_MS) for k, n in PATH_SHAPES]
                         + [(512, 512, POS_MS)])
def test_rows_bitwise_independent_of_m(cuda, kind, k, n, ms):
    fn, x = _layer_case(cuda, kind, k, n, max(ms), k + n)
    full = fn(x)
    for m in ms:
        assert torch.equal(_bits(fn(x[:m])), _bits(full[:m])), f"M={m}"


def _held_as_layer(out, ref, ref_nobias):
    out, ref, u = out.float(), ref.float(), ref_nobias.float()
    delta = (out - ref).abs()
    bound = 2.0 ** -6 * (u.abs() + ref.abs()) + 1e-5 * float(ref.abs().max())
    assert bool((delta <= bound).all())
    assert float((delta > 0).float().mean()) < 1e-2


@pytest.mark.parametrize("m,k,n", [(50, 2560, 512), (99, 512, 512), (400, 512, 2048),
                                   (50, 512, 1025), (37, 64, 130)])
def test_fused_epilogues_match_plain(cuda, m, k, n):
    rng = np.random.default_rng(m * n)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    packed, scales = (torch.from_numpy(a).to(cuda) for a in quant.pack_int4(w))
    kernels.reset_launches()
    out = quant.int4_dense(x, packed, scales, bias)
    f32 = quant.int4_matmul(x, packed, scales)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    own = f32.to(torch.bfloat16) + bias.to(torch.bfloat16)
    assert torch.equal(_bits(out), _bits(own))
    _held_as_layer(out, quant.int4_dense_plain(x, packed, scales, bias),
                   quant.int4_dense_plain(x, packed, scales))
    f32_bias = quant.int4_dense(x, packed, scales, bias, torch.float32)
    assert torch.equal(_bits(f32_bias), _bits(f32 + bias))

    q, s8 = (torch.from_numpy(a).to(cuda) for a in quant.quantize_int8(w))
    out8 = quant.int8_dense(x, q, s8, bias)
    assert out8.dtype == torch.bfloat16 and out8.shape == (m, n)
    _held_as_layer(out8, quant.int8_dense_plain(x, q, s8, bias), quant.int8_dense_plain(x, q, s8))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"int4_matmul": 3, "log_mel": 0, "int8_matmul": 1,
                               "ctc_lattice": 0, "ctc_loss": 0}


def test_streaming_cache_matches_forward_long(cuda):
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.experiments import load_runtime
    from tilawa_tpu_torch.io.bundle import EXPORTS_DIR
    from tilawa_tpu_torch.pipeline.runtime import StreamingEncoderCache

    runtime = load_runtime(EXPORTS_DIR / "stream6-int8", cuda, long_chunking=False)
    audio = load_audio(EXPORTS_DIR.parent / "benchmark" / "test_corpus" / "long_033_056.wav")
    cache = StreamingEncoderCache(runtime)
    for seconds in (17.0, 18.0):   # cold, then the tail grown: a batch of 1 against 2
        window = audio[: int(seconds * 16000)]
        lp_c, ids_c, tv_c = cache.forward(window)
        lp_f, ids_f, tv_f = runtime.forward_long(window)
        assert tv_c == tv_f and np.array_equal(ids_c, ids_f)
        assert float((lp_c[:tv_c] - lp_f[:tv_f]).abs().max()) <= 1e-5
    assert cache.hits >= 1


@pytest.fixture(scope="module")
def champion_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tilawa_tpu_torch.eval.experiments import load_champion

    return load_champion("cuda")


def test_forward_batch_async_makes_no_host_sync(champion_cuda):
    """Two B=8 forwards at the 512000 bucket make no synchronizing call
    (PyTorch's sync debug mode raises on one, and does on a pageable
    upload). Behind a 0.3 s device sleep the host queues the uploads, the
    frontend and the first two blocks of the first forward (some hundreds
    of launches, below the launch queue's depth) in under half the sleep,
    while the device still sleeps."""
    rng = np.random.default_rng(5)
    waves = [(rng.standard_normal(512000) * 0.1).astype(np.float32) for _ in range(8)]
    champion_cuda.forward_batch(waves)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        champion_cuda.forward_batch_async(waves)
        champion_cuda.forward_batch_async(waves)
        with pytest.raises(RuntimeError):
            torch.from_numpy(np.zeros(8, np.float32)).to("cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    reached = []

    def stamp(_module, _args):
        if not reached:
            reached.append((time.perf_counter(), torch.cuda.current_stream().query()))

    handle = champion_cuda.model.blocks[2].register_forward_pre_hook(stamp)
    try:
        torch.cuda._sleep(int(0.3 * 1.98e9))
        t = time.perf_counter()
        champion_cuda.forward_batch_async(waves)
        champion_cuda.forward_batch_async(waves)
    finally:
        handle.remove()
    torch.cuda.synchronize()
    at, idle = reached[0][0] - t, reached[0][1]
    print(f"host reached block 2 after {at:.4f} s, device idle then: {idle}")
    assert not idle and at < 0.15


def test_batched_rows_equal_single_forwards(champion_cuda):
    """Each v1 wav clip's row of a B=8 bucket batch (zero waves padding the
    last batch) against its B=1 forward: greedy ids equal; max |Δ log-prob|
    printed (the kernels' rows do not depend on M, the frontend sums per
    row)."""
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.pipeline.runtime import bucket_length

    corpus = Path(__file__).resolve().parent.parent / "benchmark" / "test_corpus"
    groups: dict[int, list] = {}
    for path in sorted(corpus.glob("*.wav")):
        audio = load_audio(path)
        groups.setdefault(bucket_length(len(audio)), []).append(audio)
    worst = 0.0
    for bucket, clips in sorted(groups.items()):
        for pos in range(0, len(clips), 8):
            chunk = clips[pos:pos + 8]
            waves = chunk + [np.zeros(bucket, np.float32)] * (8 - len(chunk))
            lp_b, lens_b, ids_b = champion_cuda.forward_batch(waves)
            for j, audio in enumerate(chunk):
                lp_1, ids_1, t_1 = champion_cuda.forward(audio)
                assert int(lens_b[j]) == t_1
                np.testing.assert_array_equal(ids_b[j, :t_1], ids_1)
                worst = max(worst, float((lp_b[j, :t_1] - lp_1[:t_1]).abs().max()))
    print(f"max |Δ log-prob| B=8 vs B=1: {worst}")


@pytest.mark.parametrize("k,n", [(512, 2048), (2048, 512), (512, 1025), (2560, 512)])
def test_int4_kernel_at_batched_m(cuda, k, n):
    """The batched eval's largest M (B=8 x 800 frames) against the plain
    version at the per-clip tolerance, rows bitwise those of a smaller M."""
    m = 6400
    rng = np.random.default_rng(k + n)
    packed, scales = quant.pack_int4(rng.standard_normal((k, n)).astype(np.float32))
    packed, scales = torch.from_numpy(packed).to(cuda), torch.from_numpy(scales).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    out = quant.int4_matmul(x, packed, scales)
    ref = quant.int4_matmul_plain(x, packed, scales)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(_bits(quant.int4_matmul(x[:400], packed, scales)), _bits(out[:400]))


def test_log_mel_kernel_at_the_largest_batched_bucket(cuda):
    pre = _pre(cuda, 8, 1024000, 8)
    tables = frontend.mel_tables(cuda)
    out = frontend.fused_log_mel(pre, tables)
    ref = frontend.log_mel_plain(pre, tables)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 2e-3
    alone = frontend.fused_log_mel(pre[5:6].contiguous(), tables)
    assert torch.equal(alone.view(torch.int32), out[5:6].view(torch.int32))


def test_training_step_kernel_vs_plain(cuda):
    """One full-width training step of the dequantized champion (dropout 0,
    no SpecAugment, f32 compute) with the log-mel kernel and with the plain
    log-mel: |Δ loss| and the largest per-leaf max|Δg|/max|g| within what
    ±2e-3 of noise on the plain log-mel (the kernel's bound against its
    plain version) does to the same step (chip_smoke.train_vs_plain, which
    also prints the bf16 step)."""
    out = chip_smoke.train_vs_plain(torch, np)["float32"]
    assert out["d_loss"] <= out["tol_loss"] and out["d_grad"] <= out["tol_grad"]


def test_teacher_forward_launches_int4(cuda):
    """The distillation teacher (champion-int4 as stored, under no_grad):
    189 int4 launches and one log-mel a forward; its output keeps no graph
    and can be saved for a student's backward (not an inference tensor)."""
    from tilawa_tpu_torch.io.bundle import EXPORTS_DIR
    from tilawa_tpu_torch.train.distill import load_teacher

    teacher = load_teacher(EXPORTS_DIR / "champion-int4", cuda)
    audio = torch.zeros((2, 64000), device=cuda)
    lens = torch.tensor([64000, 40000], dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    with torch.no_grad():
        lp, _ = teacher(audio, lens)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"int4_matmul": 189, "log_mel": 1, "int8_matmul": 0,
                               "ctc_lattice": 0, "ctc_loss": 0}
    assert not lp.is_inference() and lp.grad_fn is None
    student_like = torch.zeros_like(lp, requires_grad=True)
    (torch.exp(lp) * (lp - student_like)).sum().backward()
    assert student_like.grad is not None


def test_wrappers_raise_on_inputs_that_need_a_gradient(cuda):
    """On CUDA tensors, as on the CPU: an input that requires a gradient
    under grad mode raises before any launch; under no_grad the kernel runs."""
    rng = np.random.default_rng(9)
    packed, scales = (torch.from_numpy(a).to(cuda) for a in quant.pack_int4(
        rng.standard_normal((64, 32)).astype(np.float32)))
    q, s8 = (torch.from_numpy(a).to(cuda) for a in quant.quantize_int8(
        rng.standard_normal((64, 32)).astype(np.float32)))
    x = torch.randn(3, 64, device=cuda, requires_grad=True)
    pre = torch.randn(1, 4000, device=cuda, requires_grad=True)
    tables = frontend.mel_tables(cuda)
    lp = torch.randn(2, 40, 12, device=cuda).log_softmax(-1).requires_grad_()
    tokens = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([3], dtype=torch.int32, device=cuda)
    t_valid = torch.tensor([40, 20], dtype=torch.int32, device=cuda)
    calls = [lambda: quant.int4_matmul(x, packed, scales),
             lambda: quant.int4_dense(x, packed, scales),
             lambda: quant.int8_matmul(x, q, s8),
             lambda: quant.int8_dense(x, q, s8),
             lambda: frontend.fused_log_mel(pre, tables),
             lambda: ctc.ctc_forward_scores(lp[0], 40, tokens, lens, 11),
             lambda: ctc.ctc_forward_scores_batch(lp, t_valid, tokens, lens, 11)]
    kernels.reset_launches()
    for call in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            call()
    assert sum(kernels.LAUNCHES.values()) == 0
    with torch.no_grad():
        for call in calls:
            assert call().grad_fn is None
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"int4_matmul": 2, "log_mel": 1, "int8_matmul": 2,
                               "ctc_lattice": 2, "ctc_loss": 0}


@pytest.mark.parametrize("keep", [12, 8, 6])
def test_pruned_forward_launches(cuda, keep):
    """A forward of champion-int4 pruned to `keep` blocks (evenly spaced)
    launches 11·keep + 2 int4 kernels (11 a block, the projection and the
    CTC head) and one log-mel; its collapsed ids equal the plain ops' on
    the card."""
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.experiments import _pruned_runtime
    from tilawa_tpu_torch.ops.ctc import collapse_ctc

    runtime = _pruned_runtime(keep, "evenly_spaced", cuda)
    audio = load_audio(Path(__file__).resolve().parent.parent / "benchmark" / "test_corpus"
                       / "retasy_003.wav")
    runtime.forward(audio)
    torch.cuda.synchronize()
    kernels.reset_launches()
    _lp, ids, t = runtime.forward(audio)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"int4_matmul": 11 * keep + 2, "log_mel": 1,
                               "int8_matmul": 0, "ctc_lattice": 0, "ctc_loss": 0}
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime

    plain = EncoderRuntime(dataclasses.replace(runtime.config, use_pallas=False),
                           runtime.variables, cuda)
    _lp, ids_p, t_p = plain.forward(audio)
    assert t == t_p and collapse_ctc(ids, 1024) == collapse_ctc(ids_p, 1024)


def test_context_sweep_rows_equal_single_forwards(champion_cuda):
    """Each row of the context sweep's batched forward (the prefix cuts and
    the clip, B = 3-6 rows at the clip's bucket) is bitwise the same row
    forwarded alone at that bucket, so its greedy ids are too."""
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.device import upload
    from tilawa_tpu_torch.eval.context_sweep import sweep_pieces
    from tilawa_tpu_torch.pipeline.runtime import bucket_length

    corpus = Path(__file__).resolve().parent.parent / "benchmark" / "test_corpus"
    dev = torch.device("cuda")
    for clip in ("retasy_000.wav", "retasy_016.wav", "retasy_024.wav", "long_033_056.wav"):
        _keys, pieces = sweep_pieces(load_audio(corpus / clip))
        lps, t_valids = champion_cuda.log_probs_batch(pieces)
        n_pad = bucket_length(max(len(p) for p in pieces))
        for i, piece in enumerate(pieces):
            alone = np.zeros((1, n_pad), np.float32)
            alone[0, : len(piece)] = piece
            lp1, t1 = champion_cuda._apply(upload(alone, dev),
                                           upload(np.array([len(piece)], np.int32), dev))
            t = int(t_valids[i])
            assert int(t1[0]) == t
            np.testing.assert_array_equal(lps[i, :t].view(np.int32),
                                          lp1[0, :t].cpu().numpy().view(np.int32))


# (label, T, V, C, L_pad, t_valid, live lengths) of chip_smoke.LATTICE_CASES,
# a chunk whose L_pad fits one warp (a TILAWA_TOKEN_BUCKETS rung below 32)
# and an L_pad past every layout whose t_valid bounds its candidates to
# what a 16-CTA cluster holds (L up to 4,095), each under every kernel
# variant that holds its longest feasible candidate
_WARP_CASE = ("one warp", 512, 1025, 64, 31, 300, (31, 30, 17, 6, 2, 1))
_LONG_CASE = ("long", 8192, 70, 2, 8192, 8192, (4000, 100))


def _variant_fits(case, variant):
    _label, _t, _v, c, l_pad, t_valid, _lengths = case
    try:
        ctc.lattice_plan(l_pad, c, 1, variant=variant, t_valid=t_valid)
    except ValueError:
        return False
    return True


_LATTICE_VARIANT_CASES = [
    (*case, variant) for case in (*chip_smoke.LATTICE_CASES, _WARP_CASE, _LONG_CASE)
    for variant in ("warp", "group", "cluster") if _variant_fits(case, variant)
]


@pytest.mark.parametrize("label,t,v,c,l_pad,t_valid,lengths,variant", _LATTICE_VARIANT_CASES)
def test_ctc_lattice_kernel_matches_plain(cuda, label, t, v, c, l_pad, t_valid, lengths,
                                          variant):
    """The lattice calls the paths make (chip_smoke.LATTICE_CASES: the
    rerank's chunks, sparse and all live, the phoneme shapes, the tracker's
    two candidates, the chain floor) under each variant (one warp, warp
    group, cluster) that holds the longest feasible candidate: one launch,
    scores bitwise the plain version's."""
    lp, tokens, lens = chip_smoke.lattice_case(torch, np, t, v, c, l_pad, lengths,
                                               t_valid + l_pad)
    plan = ctc.lattice_plan(l_pad, c, 1, variant=variant, t_valid=t_valid)
    kernels.reset_launches()
    out = ctc._launch("test", lp[None], t_valid, tokens, lens, v - 1, plan)[0]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctc_lattice"] == 1
    ref = ctc.ctc_forward_scores_plain(lp, t_valid, tokens, lens, v - 1)
    assert out.shape == (c,) and out.dtype == torch.float32
    chip_smoke.lattice_gate(torch, label, out, ref)
    assert torch.equal(chip_smoke.bits(torch, out), chip_smoke.bits(torch, ref))
    live = (2 * lens + 1 <= t_valid) & (lens > 0)
    assert torch.equal(torch.isfinite(out), live)
    if variant == ctc.lattice_plan(l_pad, c, 1, t_valid=t_valid).variant:   # the wrapper's
        assert torch.equal(out, ctc.ctc_forward_scores(lp, t_valid, tokens, lens, v - 1))


@pytest.mark.parametrize("variant", ["group", "cluster"])
def test_ctc_lattice_batch_kernel_matches_plain(cuda, variant):
    """B = 4 rows with four t_valid (one launch), each row also against the
    single form, under the group and the cluster variant: bitwise."""
    lp, tokens, lens = chip_smoke.lattice_case(torch, np, 512, 1025, 64, 128,
                                               (128, 90, 33, 6, 1), 4)
    rows = torch.stack([lp, lp.flip(0), lp.roll(7, 0), lp * 1.5]).log_softmax(-1)
    t_valid = torch.tensor([512, 257, 100, 1], dtype=torch.int32, device=cuda)
    plan = ctc.lattice_plan(128, 64, 4, variant=variant)
    kernels.reset_launches()
    out = ctc._launch("test", rows, t_valid, tokens, lens, 1024, plan)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctc_lattice"] == 1
    assert out.shape == (4, 64)
    ref = ctc.ctc_forward_scores_batch_plain(rows, t_valid, tokens, lens, 1024)
    chip_smoke.lattice_gate(torch, "batch", out, ref)
    assert torch.equal(chip_smoke.bits(torch, out), chip_smoke.bits(torch, ref))
    for b, tv in enumerate((512, 257, 100, 1)):
        assert torch.equal(out[b], ctc.ctc_forward_scores(rows[b], tv, tokens, lens, 1024))


def test_ctc_lattice_log1p_is_cudas_for_every_float(cuda):
    """The kernel's branch-free log1pf (log1pf_flat in csrc/ctc_lattice.cu)
    against CUDA's log1pf on all 2^32 floats: no bit differs, so the
    kernel's logaddexp is torch's."""
    assert chip_smoke.lattice_log1p_mismatches(torch, kernels) == 0


def test_ctc_lattice_raises_where_no_variant_fits(cuda):
    """L_pad past every layout (a cluster of 16 CTAs of 512 threads, one
    state pair a thread) at a t_valid that lets its candidates be feasible
    raises in the wrapper, and so does a plan the kernel cannot hold (one
    warp for candidates up to L 49); neither launches."""
    lp = torch.zeros((64, 70), device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="does not fit"):
        ctc.ctc_forward_scores(lp, 1 << 20, torch.zeros((1, 40000), dtype=torch.int32,
                                                        device=cuda),
                               torch.ones(1, dtype=torch.int32, device=cuda), 69)
    small = ctc.lattice_plan(31, 1, 1, variant="warp")
    with pytest.raises(RuntimeError, match="cudaError"):
        ctc._launch("test", lp[None], 100, torch.zeros((1, 128), dtype=torch.int32, device=cuda),
                    torch.ones(1, dtype=torch.int32, device=cuda), 69, small)
    assert kernels.LAUNCHES["ctc_lattice"] == 0


def test_ctc_lattice_makes_no_host_sync(cuda):
    """With log-probs, tokens, lengths and the batch's t_valid resident on
    the card, neither form synchronizes with the host (PyTorch's sync
    debug mode raises on a synchronizing call)."""
    lp, tokens, lens = chip_smoke.lattice_case(torch, np, 512, 1025, 512, 128, (100, 50, 3), 9)
    t_valid = torch.tensor([400, 300], dtype=torch.int32, device=cuda)
    rows = torch.stack([lp, lp])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        single = ctc.ctc_forward_scores(lp, 400, tokens, lens, 1024)
        batch = ctc.ctc_forward_scores_batch(rows, t_valid, tokens, lens, 1024)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(batch[0], single)
    chip_smoke.lattice_gate(torch, "no sync", single,
                            ctc.ctc_forward_scores_plain(lp, 400, tokens, lens, 1024))


def test_rerank_scores_through_the_kernel(cuda):
    """score_token_lists on a card-resident tensor launches the lattice once
    a `_score_feasible` chunk, and its scores equal the plain version's."""
    from tilawa_tpu_torch.pipeline import rerank

    lp, _tokens, _lens = chip_smoke.lattice_case(torch, np, 512, 1025, 1, 128, (), 3)
    rng = np.random.default_rng(3)
    lists = [list(rng.integers(0, 1024, size=n)) for n in (3, 40, 200, 0, 128, 129, 17)]
    kernels.reset_launches()
    got = rerank.score_token_lists(lp, 450, lists, blank_id=1024)
    assert kernels.LAUNCHES["ctc_lattice"] == 2     # the L_pad 128 and 512 chunks
    ref = rerank.score_token_lists(lp, 450, lists, blank_id=1024, plain=True)
    assert kernels.LAUNCHES["ctc_lattice"] == 2
    chip_smoke.lattice_gate(torch, "score_token_lists", got, ref)
    np.testing.assert_array_equal(got, ref)


# The training CTC loss (csrc/ctc_loss.cu) at the training buckets' shapes:
# text at V 1,025 and phonemes at V 70 (chip_smoke.CTC_LOSS_CASES), with
# repeats, rows shorter than T and an infeasible row.
_CTC_LOSS_CASES = [chip_smoke.CTC_LOSS_CASES[i] for i in (0, 1, 6, 8, 9, 15, 16)]


def _ctc_loss_run(case, seed, weight=None):
    _label, b, t, v, l_pad, l_max = case
    x, enc, tokens, lens, blank = chip_smoke.ctc_loss_case(torch, np, b, t, v, l_pad, l_max,
                                                           seed)
    weight = torch.full((b,), 1.0 / b, device=x.device) if weight is None else weight
    xg = x.detach().requires_grad_()
    loss = ctc.ctc_loss(xg, enc, tokens, lens, blank)
    (grad,) = torch.autograd.grad(loss, xg, weight)
    return (x, enc, tokens, lens, blank, weight), loss.detach(), grad


@pytest.mark.parametrize("case", _CTC_LOSS_CASES, ids=[c[0] for c in _CTC_LOSS_CASES])
def test_ctc_loss_kernel_matches_plain(cuda, case):
    """Loss (rel 1e-5 a row) and gradient (max|Δ| ≤ 1e-4 of the plain
    max|g| a row) against ctc_loss_plain and ctc_loss_grad_plain; one
    launch forward and one backward."""
    kernels.reset_launches()
    (x, enc, tokens, lens, blank, weight), loss, grad = _ctc_loss_run(case, 5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctc_loss"] == 2
    ref_loss = ctc.ctc_loss_plain(x, enc, tokens, lens, blank)
    ref_grad = ctc.ctc_loss_grad_plain(x, enc, tokens, lens, blank, weight)
    chip_smoke.ctc_loss_gate(torch, case[0], loss, grad, ref_loss, ref_grad)
    assert kernels.LAUNCHES["ctc_loss"] == 2


_LOSS_LAYOUT_CASES = [(case, plan) for case in chip_smoke.CTC_LOSS_CASES
                      for plan in chip_smoke.loss_plans(ctc, case[4], case[1])]


@pytest.mark.parametrize("case,plan", _LOSS_LAYOUT_CASES,
                         ids=[f"{c[0]}-{p.variant}{p.cluster}" for c, p in _LOSS_LAYOUT_CASES])
def test_ctc_loss_layouts_match_plain(cuda, case, plan):
    """Every training shape under each layout loss_plan accepts there (one
    warp, one block, a cluster of each size that holds the row): the loss
    bitwise the plain one, the gradient gated against the plain one and
    bitwise the default layout's; one launch forward and one backward."""
    _label, b, t, v, l_pad, l_max = case
    x, enc, tokens, lens, blank = chip_smoke.ctc_loss_case(torch, np, b, t, v, l_pad, l_max, 11)
    weight = torch.full((b,), 1.0 / b, device=cuda)
    kernels.reset_launches()
    loss, grad = chip_smoke.ctc_loss_kernel(ctc, x, enc, tokens, lens, blank, weight, plan)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctc_loss"] == 2
    ref_loss = ctc.ctc_loss_plain(x, enc, tokens, lens, blank)
    ref_grad = ctc.ctc_loss_grad_plain(x, enc, tokens, lens, blank, weight)
    chip_smoke.ctc_loss_gate(torch, case[0], loss, grad, ref_loss, ref_grad)
    assert torch.equal(loss.view(torch.int32), ref_loss.view(torch.int32))
    _loss, default = chip_smoke.ctc_loss_kernel(ctc, x, enc, tokens, lens, blank, weight)
    assert torch.equal(grad.view(torch.int32), default.view(torch.int32))


def test_ctc_loss_rows_past_one_block(cuda):
    """Labels padded to 2,047 (rows of 2,047, 1,100 and 0 labels, one of
    them 3 frames short of its labels) through the op: a cluster layout,
    the loss bitwise the plain one, the gradient gated."""
    rng = np.random.default_rng(2047)
    v, blank, t, n = 70, 69, 2600, 2047
    x = torch.from_numpy(rng.standard_normal((3, t, v)).astype(np.float32)).to(cuda)
    tokens = torch.from_numpy(rng.integers(0, blank, (3, n)).astype(np.int32)).to(cuda)
    lens = torch.tensor([n, 1100, 0], dtype=torch.int32, device=cuda)
    need = [int(k) + int((r[1:k] == r[:k - 1]).sum()) if k else 0 for r, k in
            zip(tokens.cpu().numpy(), lens.tolist())]
    enc = torch.tensor([t, need[1] - 3, 40], dtype=torch.int32, device=cuda)
    assert ctc.loss_plan(n, 3).variant == "cluster"
    weight = torch.tensor([0.5, 1.0, 2.0], device=cuda)
    xg = x.clone().requires_grad_()
    kernels.reset_launches()
    loss = ctc.ctc_loss(xg, enc, tokens, lens, blank)
    (grad,) = torch.autograd.grad(loss, xg, weight)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctc_loss"] == 2
    ref_loss = ctc.ctc_loss_plain(x, enc, tokens, lens, blank)
    ref_grad = ctc.ctc_loss_grad_plain(x, enc, tokens, lens, blank, weight)
    chip_smoke.ctc_loss_gate(torch, "2,047 labels", loss.detach(), grad, ref_loss, ref_grad)
    assert torch.equal(loss.detach().view(torch.int32), ref_loss.view(torch.int32))


def test_ctc_loss_replays_in_a_cuda_graph(cuda):
    """Forward and backward captured in one CUDA graph (no allocation in a
    launcher, no host sync) replay bitwise what eager calls give, for the
    default layout at a block and at a cluster shape."""
    for case in (chip_smoke.CTC_LOSS_CASES[0], chip_smoke.CTC_LOSS_CASES[-1]):
        _label, b, t, v, l_pad, l_max = case
        x, enc, tokens, lens, blank = chip_smoke.ctc_loss_case(torch, np, b, t, v, l_pad,
                                                               l_max, 12)
        weight = torch.full((b,), 1.0 / b, device=cuda)
        xg = x.clone().requires_grad_()

        def step():
            loss = ctc.ctc_loss(xg, enc, tokens, lens, blank)
            (grad,) = torch.autograd.grad(loss, xg, weight)
            return loss.detach(), grad

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()                      # warm-up: builds and loads the library
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loss_g, grad_g = step()
        eager_loss, eager_grad = step()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(loss_g.view(torch.int32), eager_loss.view(torch.int32)), case[0]
        assert torch.equal(grad_g.view(torch.int32), eager_grad.view(torch.int32)), case[0]


def test_f32_train_step_is_bitwise_repeatable(cuda):
    """Two runs of one full-width f32 training step (the dequantized
    champion, plain log-mel, dropout 0, no SpecAugment) on one v1 batch:
    the loss and every gradient leaf bitwise equal."""
    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.models.fastconformer import FastConformerCTC
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.data import bucketed_corpus_batches
    from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config
    from tilawa_tpu_torch.train.train import step_generator

    cfg, variables = load_variables(chip_smoke.CHAMPION)
    variables = dequantize_variables(variables)
    cfg = dequantized_config(cfg, dtype=torch.float32, use_pallas=False, dropout=0.0,
                             sa_freq_masks=0, sa_time_masks=0)
    batch = next(bucketed_corpus_batches(("v1",), seed=1, augment=False))
    runs = []
    for _ in range(2):
        model = load_into(FastConformerCTC(cfg), variables).to(cuda)
        runs.append(chip_smoke._one_step(torch, model, batch,
                                         step_generator(0, 1, torch.device(cuda))))
        del model
    (la, ga), (lb, gb) = runs
    assert la == lb
    moved = [n for n in ga if not torch.equal(ga[n].view(torch.int32), gb[n].view(torch.int32))]
    assert not moved, moved[:5]


def test_ctc_loss_kernel_edge_rows(cuda):
    """L = 0, a last label equal to the padding token, a row that fills the
    padded width, enc_len 0 and past T, a label equal to its neighbour,
    and per-row upstream weights (distillation's per-token division)."""
    rng = np.random.default_rng(3)
    v, blank = 9, 8
    x = torch.from_numpy(rng.standard_normal((5, 16, v)).astype(np.float32)).to(cuda)
    enc = torch.tensor([16, 12, 16, 0, 40], dtype=torch.int32, device=cuda)
    tokens = torch.tensor([[0, 0, 0, 0, 0, 0], [3, 5, 0, 0, 0, 0], [1, 2, 2, 4, 6, 7],
                           [2, 3, 0, 0, 0, 0], [4, 4, 1, 2, 0, 0]], dtype=torch.int32,
                          device=cuda)
    lens = torch.tensor([0, 3, 6, 2, 4], dtype=torch.int32, device=cuda)
    weight = 1.0 / lens.clamp(min=1).float() / 5
    xg = x.clone().requires_grad_()
    loss = ctc.ctc_loss(xg, enc, tokens, lens, blank)
    (grad,) = torch.autograd.grad(loss, xg, weight)
    ref_loss = ctc.ctc_loss_plain(x, enc, tokens, lens, blank)
    ref_grad = ctc.ctc_loss_grad_plain(x, enc, tokens, lens, blank, weight)
    chip_smoke.ctc_loss_gate(torch, "edge rows", loss.detach(), grad, ref_loss, ref_grad)
    assert not bool(grad[3].any()) and not bool(grad[1, 12:].any())


def test_ctc_loss_label_outside_the_vocabulary_gives_a_nan_row(cuda):
    """A label >= V or < 0 (in the first warp's states, or past them where
    the row's chain spans two warps) gives that row a NaN loss and a NaN
    gradient row; the other rows keep the plain version's loss and
    gradient."""
    rng = np.random.default_rng(4)
    v, blank, n = 9, 8, 40
    x = torch.from_numpy(rng.standard_normal((4, 60, v)).astype(np.float32)).to(cuda)
    enc = torch.full((4,), 60, dtype=torch.int32, device=cuda)
    tokens = torch.from_numpy(rng.integers(0, blank, (4, n)).astype(np.int32)).to(cuda)
    tokens[1, 1], tokens[2, 35], tokens[3, 0] = v, v + 3, -1
    lens = torch.tensor([3, 3, n, 2], dtype=torch.int32, device=cuda)
    xg = x.clone().requires_grad_()
    loss = ctc.ctc_loss(xg, enc, tokens, lens, blank)
    (grad,) = torch.autograd.grad(loss, xg, torch.ones(4, device=cuda))
    assert bool(loss[1:].isnan().all()) and bool(grad[1:].isnan().all())
    ref_loss = ctc.ctc_loss_plain(x[:1], enc[:1], tokens[:1], lens[:1], blank)
    ref_grad = ctc.ctc_loss_grad_plain(x[:1], enc[:1], tokens[:1], lens[:1], blank,
                                       torch.ones(1, device=cuda))
    chip_smoke.ctc_loss_gate(torch, "good row", loss[:1].detach(), grad[:1], ref_loss, ref_grad)


def test_ctc_loss_kernel_is_bitwise_run_to_run(cuda):
    """No float atomics: two runs give the same bits."""
    case = chip_smoke.CTC_LOSS_CASES[0]
    _args, loss, grad = _ctc_loss_run(case, 7)
    _args, loss2, grad2 = _ctc_loss_run(case, 7)
    assert torch.equal(loss.view(torch.int32), loss2.view(torch.int32))
    assert torch.equal(grad.view(torch.int32), grad2.view(torch.int32))


def test_ctc_loss_makes_no_host_sync(cuda):
    """With x, lengths and labels on the card, forward and backward make no
    synchronizing call (PyTorch's sync debug mode raises on one)."""
    _label, b, t, v, l_pad, l_max = chip_smoke.CTC_LOSS_CASES[1]
    x, enc, tokens, lens, blank = chip_smoke.ctc_loss_case(torch, np, b, t, v, l_pad, l_max, 2)
    xg = x.detach().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = ctc.ctc_loss(xg, enc, tokens, lens, blank).mean()
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xg.grad).all())


def test_ctc_loss_raises_on_what_it_does_not_take(cuda):
    """A wrong dtype, lengths on another device, a DTensor-like input, labels
    padded past what 16 CTAs hold, a vocabulary past the epilogue's: raised
    before any launch."""
    x = torch.zeros((2, 5, 4), device=cuda)
    enc = torch.tensor([5, 5], dtype=torch.int32, device=cuda)
    tokens = torch.ones((2, 3), dtype=torch.int32, device=cuda)
    lens = torch.tensor([3, 3], dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="float32"):
        ctc.ctc_loss(x.double(), enc, tokens, lens, 3)
    with pytest.raises(ValueError, match="must be on"):
        ctc.ctc_loss(x, enc.cpu(), tokens, lens, 3)
    with pytest.raises(TypeError, match="DTensor"):
        ctc.ctc_loss(type("Sharded", (), {"to_local": None})(), enc, tokens, lens, 3)
    with pytest.raises(ValueError, match="do not fit"):
        ctc.ctc_loss(x, enc, torch.ones((2, ctc.CTC_LOSS_MAX_LABELS + 1), dtype=torch.int32,
                                        device=cuda), lens, 3)
    with pytest.raises(ValueError, match="classes"):
        ctc.ctc_loss(torch.zeros((2, 5, 9000), device=cuda), enc, tokens, lens, 3)
    with pytest.raises(ValueError, match="blank"):
        ctc.ctc_loss(x, enc, tokens, lens, 4)
    assert kernels.LAUNCHES["ctc_loss"] == 0
