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
widen that flip to two ulps of the output); log-mel, 2e-3 (direct DFT vs
FFT in f32, the bound tests/test_frontend.py holds the JAX fused kernel
to)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tilawa_tpu_torch.ops import frontend, kernels, quant  # noqa: E402

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


@pytest.mark.parametrize("b,n", [(2, 64000), (1, 12345), (3, 400)])
def test_log_mel_kernel_matches_plain(cuda, b, n):
    rng = np.random.default_rng(n)
    pre = torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32)).to(cuda)
    tables = frontend.mel_tables(cuda)
    kernels.reset_launches()
    out = frontend.fused_log_mel(pre, tables)
    ref = frontend.log_mel_plain(pre, tables)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["log_mel"] == 1
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 2e-3


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
    assert kernels.LAUNCHES == {"int4_matmul": 189, "log_mel": 1, "int8_matmul": 0}
    _lp, ids_p, t_p = plain_rt.forward(audio)
    assert kernels.LAUNCHES == {"int4_matmul": 189, "log_mel": 1, "int8_matmul": 0}
    assert t_k == t_p
    assert collapse_ctc(ids_k, 1024) == collapse_ctc(ids_p, 1024)


INT8_SHAPES = [
    (50, 2560, 512), (99, 512, 512), (50, 512, 1024), (400, 512, 2048),
    (50, 2048, 512), (50, 512, 1025), (1, 32, 3), (37, 64, 130),
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
    assert kernels.LAUNCHES == {"int4_matmul": 0, "log_mel": 1, "int8_matmul": 189}
    _lp, ids_p, t_p = plain_rt.forward(audio)
    assert kernels.LAUNCHES == {"int4_matmul": 0, "log_mel": 1, "int8_matmul": 189}
    assert t_k == t_p
    assert collapse_ctc(ids_k, 1024) == collapse_ctc(ids_p, 1024)
