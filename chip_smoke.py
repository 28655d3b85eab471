#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases (each prints its elapsed seconds; any failure exits non-zero
without the final line):

  1. device      card name, count, nvidia-smi name and power limit
  2. build       nvcc the three hand-written kernels (in parallel) for
                 sm_90a; ptxas registers / shared memory / spills
  3. kernels     each kernel against its plain PyTorch version on the card
                 at every shape the paths launch (int8 in both orders of
                 scaling), with timings of the kernel, the plain version
                 and a one-call library yardstick
  4. main path   champion-int4 Recognizer(tta=True).predict over wav clips
                 of benchmark/test_corpus (each must match the manifest),
                 plus the >25 s transcribe fallback; launch counters are
                 zeroed just before and read just after
  5. plain path  the same model with the plain ops on the card for one
                 clip: same collapsed greedy ids, max |Δ log-prob| printed
  6. trace       a short and a long clip's forward and predict on the host
                 clock with the int4 kernel's split-K on and forced off,
                 interleaved, and each forward under torch.profiler: device
                 busy share and the kernels that take the device time
  7. streaming   stream6-int8 (int8 Dense): one forward's launches and its
                 device busy share under torch.profiler, then v1 clips
                 replayed through validate_streaming's
                 RecitationTracker in 300 ms chunks (each must score
                 sequence accuracy 1.0), with per-cycle forward, fusion
                 scoring and feed times; counters zeroed just before the
                 replay and read just after
  8. cache       StreamingEncoderCache on a window over 16 s, cold and
                 with its tail grown by 1 s, against forward_long
  9. server      the port's WebSocket server in-process on 127.0.0.1
                 (TILAWA_CHECKPOINT=exports/stream6-int8, tracker engine)
                 and two ws_client streams at once, each of which must get
                 a verse_match for its clip's verse
  10. champion  the trace's two clips' forward and predict once more, in
      again      the process state the three phases before leave behind

The last three lines: nvidia-smi's name and power limit, one JSON object
with every kernel's numbers, and {"ok": true, "device": {...}}.
Imports nothing of JAX, flax, msgpack or tilawa_tpu.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CORPUS = ROOT / "benchmark" / "test_corpus"
CLIPS = (
    "retasy_000.wav", "retasy_003.wav", "retasy_010.wav", "retasy_016.wav",
    "retasy_017.wav", "retasy_024.wav", "multi_113_001_005.wav",
    "long_033_056.wav",
)
LONG_CLIP = "multi_114_001_006.wav"   # 41 s: takes the 25 s transcribe fallback
STREAM_BUNDLE = ROOT / "exports" / "stream6-int8"
# v1 clips the JAX package's tracker gets right on stream6-int8 (sequence
# accuracy 1.0 in its recorded v1 streaming run and on the CPU)
STREAM_IDS = ("retasy_003", "retasy_010", "multi_103_001_003", "ref_033056")
SERVER_CLIPS = ("retasy_003.wav", "retasy_010.wav")
SEED = 0
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core and f32 CUDA-core operations/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12

INT4_TOL = 1e-5     # max|Δ| ≤ INT4_TOL · max|ref|: same bf16 operands, f32 sums in another
                    # order; a W left unrounded to bf16 errs by ~1e-3 · max|ref| (checked below)
INT8_TOL = 1e-5     # scale in W (_int8_kernel's order): as INT4_TOL
INT8_ULP2 = 2.0 ** -6  # scale after (Int8Dense's order), bf16 out: a last-bit flip of the
                       # rounded product bf16(acc) (f32 sums in another order) moves y =
                       # bf16(bf16(acc)·s) by up to two bf16 ulps, 2^-6·|y|; each element is
                       # held to that (+ INT8_TOL · max|ref| for sums that cancel) and
FLIP_RATE = 1e-2       # under 1% of the elements may differ at all; a product left
                       # unrounded before the scale differs in ~25% (checked below)
MEL_TOL = 2e-3      # max|Δ log-mel|: direct DFT vs FFT in f32 (tests/test_frontend.py holds the
                    # JAX fused kernel to the same bound against its rfft path)

# The champion's int4 products per forward, (K, N, launches), at M encoder
# rows (pos runs over the 2T-1 relative positions).
INT4_SHAPES = (
    ("proj", 2560, 512, 1),
    ("q/k/v/out", 512, 512, 4 * 17),
    ("pos", 512, 512, 17),
    ("pw1", 512, 1024, 17),
    ("pw2", 512, 512, 17),
    ("lin1", 512, 2048, 2 * 17),
    ("lin2", 2048, 512, 2 * 17),
    ("ctc_head", 512, 1025, 1),
)
INT4_LAUNCHES_PER_FORWARD = sum(s[3] for s in INT4_SHAPES)
# stream6-int8 runs the same 189 products as Int8Dense layers
INT8_LAUNCHES_PER_FORWARD = INT4_LAUNCHES_PER_FORWARD
M_MAIN = 50          # encoder frames of the 64000-sample (4 s) bucket
# encoder frames of the audio buckets the main and streaming paths reach:
# 4, 8, 16 and 32 s (clips and windows up to 30 s; 25 s transcribe windows)
PATH_T = (50, 100, 200, 400)


def path_ms(name: str) -> tuple[int, ...]:
    """The rows M a product runs at on the paths (pos at 2T-1)."""
    return tuple(2 * t - 1 for t in PATH_T) if name == "pos" else PATH_T


class PhaseFailed(Exception):
    pass


_T0 = time.perf_counter()


@contextmanager
def phase(name: str):
    t = time.perf_counter()
    print(f"== {name}", flush=True)
    try:
        yield
    except Exception as e:  # noqa: BLE001 — every phase failure ends the run
        traceback.print_exc()
        raise PhaseFailed(f"{name}: {e}") from e
    print(f"== {name} ok in {time.perf_counter() - t:.1f} s "
          f"(total {time.perf_counter() - _T0:.1f} s)", flush=True)


def time_cuda(torch, fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() with CUDA events, L2 flushed before each
    call (the main path finds each layer's weights cold)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def int4_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    nbytes = m * k * 2 + (k // 2) * n + (-(-k // 32)) * n * 4 + m * n * 4
    flops = 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int8_bound_ms(m: int, k: int, n: int, out_bytes: int) -> tuple[float, str]:
    nbytes = m * k * 2 + k * n + n * 4 + m * n * out_bytes
    flops = 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mel_bound_ms(b: int, n: int, t: int, fb_nonzeros: int) -> tuple[float, str]:
    """What the log-mel function needs, not what the direct-DFT kernel does:
    the audio read once and the log-mels written once; per frame a 512-point
    real FFT (2.5·n·log2 n), the power (3 per bin), the mel step over the
    filterbank's non-zero weights (2 each) and the log (1 per mel)."""
    nbytes = b * n * 4 + b * t * 80 * 4
    flops = b * t * (2.5 * 512 * 9 + 3 * 257 + 2 * fb_nonzeros + 80)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_int4(torch, np, quant, flush) -> dict:
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    max_err, totals = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for name, k, n, count in INT4_SHAPES:
        packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8)).to(dev)
        scales = torch.from_numpy(
            (rng.uniform(0.5, 1.5, (k // 32, n)) / (7 * np.sqrt(k))).astype(np.float32)
        ).to(dev)
        w_f32 = quant._unpack_int4_torch(packed, scales, 32)
        w_bf16 = w_f32.to(torch.bfloat16)
        for m in path_ms(name):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
            x = x.to(torch.bfloat16)
            out = quant.int4_matmul(x, packed, scales)
            ref = quant.int4_matmul_plain(x, packed, scales)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            max_err = max(max_err, err)
            if not err <= INT4_TOL * scale:
                raise AssertionError(f"int4 {name} M={m}: max|Δ| {err} > {INT4_TOL} * {scale}")
            # the tolerance must catch a kernel that skips the bf16 rounding of W
            unrounded = float((torch.matmul(x.float(), w_f32) - ref).abs().max())
            if not unrounded > INT4_TOL * scale:
                raise AssertionError(f"int4 {name} M={m}: tolerance blind to unrounded W "
                                     f"({unrounded} <= {INT4_TOL} * {scale})")
            ms = time_cuda(torch, lambda: quant.int4_matmul(x, packed, scales), flush)
            plain = time_cuda(torch, lambda: quant.int4_matmul_plain(x, packed, scales), flush)
            lib = time_cuda(torch, lambda: torch.matmul(x, w_bf16), flush)
            bound, by = int4_bound_ms(m, k, n)
            print(f"  int4 {name:9s} M={m:3d} K={k:4d} N={n:4d}  max|Δ|={err:.3g} "
                  f"(ref max {scale:.3g}, unrounded W {unrounded:.3g})  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                  f"torch.matmul(bf16 W) {lib:.4f} ms  bound {bound:.5f} ms ({by})",
                  flush=True)
            if m == (2 * M_MAIN - 1 if name == "pos" else M_MAIN):
                totals["ms"] += count * ms
                totals["plain_ms"] += count * plain
                totals["library_ms"] += count * lib
                totals["bound_ms"] += count * bound
                bound_by.add(by)
    print(f"  int4 per forward at M={M_MAIN} ({INT4_LAUNCHES_PER_FORWARD} launches): "
          + ", ".join(f"{k} {v:.4f}" for k, v in totals.items()), flush=True)
    return {
        "name": "int4_matmul", "route": "cuda",
        "source": "tilawa_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "tilawa_tpu/ops/quant.py:131",
        "max_abs_err": max_err, **totals,
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
    }


def check_int8(torch, np, quant, flush) -> dict:
    """Both orders of scaling at every product of the streaming forward.
    The JSON entry carries Int8Dense's order (what the path launches); the
    _int8_kernel order's numbers ride beside it under scale_in_w_*."""
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device(DEVICE)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    totals = {order: dict.fromkeys(keys, 0.0) for order in ("after", "in_w")}
    max_err = {"after": 0.0, "in_w": 0.0}
    flips, elems, bound_by = 0, 0, set()
    for name, k, n, count in INT4_SHAPES:
        q, scales = quant.quantize_int8(
            (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
        q, scales = torch.from_numpy(q).to(dev), torch.from_numpy(scales).to(dev)
        w_f32 = q.float() * scales
        w_bf16 = w_f32.to(torch.bfloat16)
        for m in path_ms(name):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
            x = x.to(torch.bfloat16)
            # scale in W: f32 out, held like int4
            out = quant.int8_matmul(x, q, scales)
            ref = quant.int8_matmul_plain(x, q, scales)
            torch.cuda.synchronize()
            err_w = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if not err_w <= INT8_TOL * scale:
                raise AssertionError(f"int8 (scale in W) {name} M={m}: max|Δ| {err_w} > {INT8_TOL} * {scale}")
            unrounded = float((torch.matmul(x.float(), w_f32) - ref).abs().max())
            if not unrounded > INT8_TOL * scale:
                raise AssertionError(f"int8 {name} M={m}: tolerance blind to unrounded W "
                                     f"({unrounded} <= {INT8_TOL} * {scale})")
            # scale after: bf16 out, last-bit flips only
            out_d = quant.int8_dense(x, q, scales).float()
            ref_d = quant.int8_dense_plain(x, q, scales).float()
            torch.cuda.synchronize()
            delta = (out_d - ref_d).abs()
            scale_d = float(ref_d.abs().max())
            n_flips = int((delta > 0).sum())
            if not bool((delta <= INT8_ULP2 * ref_d.abs() + INT8_TOL * scale_d).all()) \
                    or n_flips > FLIP_RATE * delta.numel():
                raise AssertionError(f"int8 (scale after) {name} M={m}: more than last-bit "
                                     f"flips (max|Δ| {float(delta.max())}, {n_flips} flips)")
            # the flip-rate gate must catch a product left unrounded before the scale
            acc = torch.matmul(x.float(), q.float())
            unrounded_flips = int(((acc * scales.to(torch.bfloat16).float()).to(torch.bfloat16)
                                   .float() != ref_d).sum())
            if not unrounded_flips > FLIP_RATE * delta.numel():
                raise AssertionError(f"int8 {name} M={m}: flip-rate gate blind to an unrounded "
                                     f"product ({unrounded_flips} flips)")
            flips, elems = flips + n_flips, elems + delta.numel()
            max_err["in_w"] = max(max_err["in_w"], err_w)
            max_err["after"] = max(max_err["after"], float(delta.max()))

            timings = {
                "in_w": (lambda: quant.int8_matmul(x, q, scales),
                         lambda: quant.int8_matmul_plain(x, q, scales), 4),
                "after": (lambda: quant.int8_dense(x, q, scales),
                          lambda: quant.int8_dense_plain(x, q, scales), 2),
            }
            lib = time_cuda(torch, lambda: torch.matmul(x, w_bf16), flush)
            line = []
            for order, (kernel_fn, plain_fn, out_bytes) in timings.items():
                ms = time_cuda(torch, kernel_fn, flush)
                plain = time_cuda(torch, plain_fn, flush)
                bound, by = int8_bound_ms(m, k, n, out_bytes)
                line.append(f"{order}: kernel {ms:.4f} plain {plain:.4f} bound {bound:.5f} ({by})")
                if m == (2 * M_MAIN - 1 if name == "pos" else M_MAIN):
                    for key, v in zip(keys, (ms, plain, lib, bound)):
                        totals[order][key] += count * v
                    if order == "after":
                        bound_by.add(by)
            print(f"  int8 {name:9s} M={m:3d} K={k:4d} N={n:4d}  scale-in-W max|Δ|={err_w:.3g} "
                  f"(ref max {scale:.3g}, unrounded W {unrounded:.3g}); scale-after flips "
                  f"{n_flips}/{delta.numel()} max|Δ|={float(delta.max()):.3g} (unrounded product "
                  f"{unrounded_flips})  "
                  + "; ".join(line) + f"; torch.matmul(bf16 W) {lib:.4f} ms", flush=True)
    for order, t in totals.items():
        print(f"  int8 ({order}) per forward at M={M_MAIN} ({INT8_LAUNCHES_PER_FORWARD} launches): "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    print(f"  int8 (after) last-bit flip rate {flips}/{elems} = {flips / elems:.3g}", flush=True)
    return {
        "name": "int8_matmul", "route": "cuda",
        "source": "tilawa_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "tilawa_tpu/ops/quant.py:150",
        "max_abs_err": max_err["after"], **totals["after"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "scale_in_w_max_abs_err": max_err["in_w"],
        **{f"scale_in_w_{k}": v for k, v in totals["in_w"].items()},
        "flip_rate": flips / elems,
    }


def check_log_mel(torch, np, frontend, flush) -> dict:
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device(DEVICE)
    tables = frontend.mel_tables(dev)
    window = tables.window
    entry = None
    max_err = 0.0
    for n in (64000, 256000):
        b = 2
        audio = torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32)).to(dev)
        pre = torch.cat([audio[:, :1], audio[:, 1:] - frontend.PREEMPH * audio[:, :-1]], dim=1)
        out = frontend.fused_log_mel(pre, tables)
        ref = frontend.log_mel_plain(pre, tables)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        if not err <= MEL_TOL:
            raise AssertionError(f"log-mel B={b} N={n}: max|Δ| {err} > {MEL_TOL}")

        def library():
            # stft centres the 400-sample window in each 512-point frame; a
            # 56-sample pad on both sides makes its frames ours (the power
            # spectrum does not see the circular shift)
            padded = torch.nn.functional.pad(pre, (56, 56))
            spec = torch.stft(padded, n_fft=512, hop_length=160, win_length=400,
                              window=window, center=False, return_complex=True)
            power = spec.real ** 2 + spec.imag ** 2                     # [B, 257, T]
            return torch.log(torch.matmul(power.transpose(1, 2), tables.fb) + 1e-5)

        lib_err = float((library() - ref).abs().max())
        ms = time_cuda(torch, lambda: frontend.fused_log_mel(pre, tables), flush)
        plain = time_cuda(torch, lambda: frontend.log_mel_plain(pre, tables), flush)
        lib = time_cuda(torch, library, flush)
        bound, by = mel_bound_ms(b, n, out.shape[1], int((tables.fb != 0).sum()))
        print(f"  log-mel B={b} N={n} T={out.shape[1]}  max|Δ|={err:.3g} (stft yardstick "
              f"{lib_err:.3g})  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
              f"stft+matmul {lib:.4f} ms  bound {bound:.5f} ms ({by})", flush=True)
        if n == 64000:
            entry = {
                "name": "log_mel", "route": "cuda",
                "source": "tilawa_tpu_torch/csrc/log_mel.cu",
                "replaces": "tilawa_tpu/ops/frontend.py:134",
                "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": lib,
            }
    entry["max_abs_err"] = max_err
    return entry


def _pcts(values: list[float]) -> str:
    if not values:
        return "-"
    v = sorted(values)
    return f"{v[len(v) // 2] * 1e3:.2f}/{v[int(0.9 * (len(v) - 1))] * 1e3:.2f}"


def streaming(torch, kernels, rerank, validate_streaming, recognizer) -> dict:
    """Replay STREAM_IDS through the port's validate_streaming harness, one
    clip at a time, timing each cycle's forward (the runtime's forward ends
    in a host read of the ids) and each call of the tracker's CTC fusion
    scorer. Returns the launch counts of the replay."""
    runtime = recognizer.runtime
    forward_s: list[float] = []
    scoring_s: list[float] = []
    real_forward, real_score = runtime.forward, rerank.score_token_lists

    def timed_forward(audio):
        t = time.perf_counter()
        out = real_forward(audio)
        forward_s.append(time.perf_counter() - t)
        return out

    def timed_score(*args, **kw):
        t = time.perf_counter()
        out = real_score(*args, **kw)
        scoring_s.append(time.perf_counter() - t)
        return out

    def transcribe(audio):
        return recognizer.transcribe_result(audio)

    db, store = recognizer.db, recognizer.token_store
    runtime.forward = timed_forward
    rerank.score_token_lists = timed_score
    wrong = []
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        runtime.forwards = 0
        for clip_id in STREAM_IDS:
            forward_s.clear()
            scoring_s.clear()
            res = validate_streaming.run_validation(
                transcribe, ids={clip_id}, db=db, token_store=store, verbose=False)
            row = res["per_sample"][0]
            got = [(e["surah"], e["ayah"]) for e in row["predicted"]]
            print(f"  {clip_id:18s} seq_acc {row['sequence_accuracy']:.2f} got {got}  "
                  f"wall {row['latency'] * 1e3:.1f} ms  cycles {len(forward_s)}  "
                  f"p50/p90 ms: forward {_pcts(forward_s)}, fusion scoring {_pcts(scoring_s)} "
                  f"({len(scoring_s)} calls), feed {res['cycle_p50'] * 1e3:.1f}/"
                  f"{res['cycle_p90'] * 1e3:.1f}, decode feed {res['decode_cycle_p50'] * 1e3:.1f}/"
                  f"{res['decode_cycle_p90'] * 1e3:.1f}", flush=True)
            if row["sequence_accuracy"] != 1.0 or res["total"] != 1:
                wrong.append(clip_id)
        torch.cuda.synchronize()
        launches, forwards = dict(kernels.LAUNCHES), runtime.forwards
    finally:
        del runtime.forward
        rerank.score_token_lists = real_score
    print(f"  replay: {forwards} forwards; launches {launches}", flush=True)
    if wrong:
        raise AssertionError(f"streaming clips below sequence accuracy 1.0: {wrong}")
    if forwards == 0 or launches["int8_matmul"] != INT8_LAUNCHES_PER_FORWARD * forwards \
            or launches["log_mel"] != forwards or launches["int4_matmul"] != 0:
        raise AssertionError("the streaming path did not run the int8 and log-mel kernels "
                             "once per layer and forward")
    return launches


def cache_check(np, load_audio, runtime, cache_cls) -> None:
    """A window over 16 s through StreamingEncoderCache cold, then with its
    tail grown by 1 s: t_valid and ids equal to forward_long's."""
    audio = load_audio(CORPUS / "long_033_056.wav")
    cache = cache_cls(runtime)
    for seconds in (17.0, 18.0):
        window = audio[: int(seconds * 16000)]
        lp_c, ids_c, tv_c = cache.forward(window)
        lp_f, ids_f, tv_f = runtime.forward_long(window)
        delta = float((lp_c[:tv_c] - lp_f[:tv_f]).abs().max()) if tv_c == tv_f else float("nan")
        same = tv_c == tv_f and np.array_equal(ids_c, ids_f)
        print(f"  window {len(window)} samples: t_valid {tv_c} vs forward_long {tv_f}, ids "
              f"{'equal' if same else 'DIFFER'}, max|Δ log-prob| {delta:.4g}; hits {cache.hits} "
              f"misses {cache.misses}", flush=True)
        if not same:
            raise AssertionError("the streaming cache disagrees with forward_long")
    if cache.hits < 1:
        raise AssertionError("the grown window did not reuse the cached chunk")


def serve(np, manifest) -> None:
    """The port's server in-process with the tracker engine; two ws_client
    streams at once; each must get a verse_match for its clip's verse."""
    from tilawa_tpu_torch.streaming import ws as wslib
    from tilawa_tpu_torch.streaming import ws_client
    from tilawa_tpu_torch.streaming.server import ModelLoader, RecitationServer

    async def scenario():
        loader = ModelLoader(device=DEVICE).start()
        server = RecitationServer(loader, engine="tracker")
        srv = await wslib.serve(server.handle, "127.0.0.1", 0, http_handler=server.api.handle)
        port = srv.sockets[0].getsockname()[1]
        try:
            t = time.perf_counter()
            while not loader.ready:
                if loader.state.get("phase") == "error":
                    raise RuntimeError(f"model load failed: {loader.state}")
                if time.perf_counter() - t > 300:
                    raise TimeoutError(f"model not ready: {loader.state}")
                await asyncio.sleep(0.2)
            print(f"  server on 127.0.0.1:{port}: {loader.weights} ready in "
                  f"{time.perf_counter() - t:.1f} s ({loader.model_size_bytes} B)", flush=True)
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                results = await asyncio.gather(*(
                    ws_client.stream_file(str(CORPUS / clip), "127.0.0.1", port, wait_s=10.0)
                    for clip in SERVER_CLIPS))
            elapsed = time.perf_counter() - t
        finally:
            srv.close()
            await srv.wait_closed()
        micro = server._model_state().get("micro_batch", {})
        print(f"  two clients streamed in {elapsed:.1f} s; dispatcher {micro}", flush=True)
        for clip, messages in zip(SERVER_CLIPS, results):
            want = {(v["surah"], v["ayah"]) for v in manifest[clip]["expected_verses"]}
            got = [(m["surah"], m["ayah"]) for m in messages if m.get("type") == "verse_match"]
            print(f"  {clip}: {len(messages)} messages, verse_match {got}, expected "
                  f"{sorted(want)}", flush=True)
            if not want & set(got):
                raise AssertionError(f"{clip}: no verse_match for {sorted(want)}")

    previous = os.environ.get("TILAWA_CHECKPOINT")
    os.environ["TILAWA_CHECKPOINT"] = str(STREAM_BUNDLE)
    try:
        asyncio.run(scenario())
    finally:
        if previous is None:
            del os.environ["TILAWA_CHECKPOINT"]
        else:
            os.environ["TILAWA_CHECKPOINT"] = previous


def host_ms(runtime, recognizer, audio) -> tuple[float, float]:
    """Host-clock milliseconds of one forward (it ends in a host read of the
    ids) and one predict of a clip."""
    t = time.perf_counter()
    runtime.forward(audio)
    fwd = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    recognizer.predict_audio(audio)
    return fwd, (time.perf_counter() - t) * 1e3


def device_busy(torch, runtime, audio, fwd_ms: float, top: int) -> None:
    """One forward under torch.profiler: device busy time, its share of the
    host-clock forward, and the `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runtime.forward(audio)
        torch.cuda.synchronize()
    stats = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(device_us(e) for e in stats) / 1e3
    if busy_ms <= 0:
        print("    profiler saw no device time: device busy share not measured", flush=True)
        return
    print(f"    profiled forward: device busy {busy_ms:.3f} ms "
          f"= {100 * busy_ms / fwd_ms:.1f}% of the median forward", flush=True)
    for e in sorted(stats, key=device_us, reverse=True)[:top]:
        print(f"    {device_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}", flush=True)


def trace(torch, quant, runtime, recognizer, clips, reps: int = 12) -> None:
    """Where a clip's time goes, and what split-K does to it end to end:
    `reps` forwards and predicts of each clip with the int4 kernel's default
    split-K and as many with splits forced to 1, alternated call by call in
    the order split, single, single, split so that drift of the host's
    speed falls on both alike. Measured and printed; no gate."""
    default_splits = quant._MAX_SPLITS
    order = ("split-K", "splits=1", "splits=1", "split-K")
    try:
        for name, audio in clips:
            times = {"split-K": ([], []), "splits=1": ([], [])}
            host_ms(runtime, recognizer, audio)
            for i in range(2 * reps):
                variant = order[i % 4]
                quant._MAX_SPLITS = default_splits if variant == "split-K" else 1
                fwd, pred = host_ms(runtime, recognizer, audio)
                times[variant][0].append(fwd)
                times[variant][1].append(pred)
            for variant, (fwd, pred) in times.items():
                quant._MAX_SPLITS = default_splits if variant == "split-K" else 1
                fwd_ms, pred_ms = sorted(fwd)[len(fwd) // 2], sorted(pred)[len(pred) // 2]
                print(f"  {name} {variant}: median of {len(fwd)}: forward {fwd_ms:.2f} ms "
                      f"(host clock, ends in a host read), predict {pred_ms:.2f} ms", flush=True)
                device_busy(torch, runtime, audio, fwd_ms, top=8 if variant == "split-K" else 2)
    finally:
        quant._MAX_SPLITS = default_splits


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval import validate_streaming
    from tilawa_tpu_torch.eval.experiments import load_champion, load_runtime
    from tilawa_tpu_torch.eval.metrics import best_emission_score, predict_to_emissions
    from tilawa_tpu_torch.io.bundle import load_variables, shipped_checkpoint
    from tilawa_tpu_torch.ops import frontend, kernels, quant
    from tilawa_tpu_torch.ops.ctc import collapse_ctc
    from tilawa_tpu_torch.pipeline import rerank
    from tilawa_tpu_torch.pipeline.predict import Recognizer
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime, StreamingEncoderCache

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
              f"{count} device(s); nvidia-smi: {smi}", flush=True)

    with phase("build"):
        report = kernels.build()
        for name, r in report.items():
            print(f"  {name}: {r['seconds']:.1f} s -> {Path(r['path']).name}", flush=True)
            for line in r["log"].splitlines():
                if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
                    print(f"    {line.strip()}", flush=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    with phase("kernels vs plain"):
        entries = [
            check_int4(torch, np, quant, flush),
            check_log_mel(torch, np, frontend, flush),
            check_int8(torch, np, quant, flush),
        ]
    del flush

    manifest = {
        s["file"]: s
        for s in json.loads((CORPUS / "manifest.json").read_text())["samples"]
    }
    with phase("main path"):
        runtime = load_champion(DEVICE)
        recognizer = Recognizer(runtime, tta=True)
        recognizer.predict(CORPUS / CLIPS[0])          # warm-up (cuDNN, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        runtime.forwards = 0
        results = []
        for clip in CLIPS:
            t = time.perf_counter()
            pred = recognizer.predict(CORPUS / clip)
            latency = time.perf_counter() - t
            sample = manifest[clip]
            score = best_emission_score(
                sample["expected_verses"], predict_to_emissions(pred),
                sample.get("also_accept"),
            )
            results.append((clip, pred, latency, score["sequence_accuracy"]))
        t = time.perf_counter()
        long_text = recognizer.transcribe(CORPUS / LONG_CLIP)
        long_latency = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        forwards = runtime.forwards
        peak = torch.cuda.max_memory_allocated()
        for clip, pred, latency, acc in results:
            print(f"  {clip:24s} -> {pred['surah']}:{pred['ayah']}-{pred['ayah_end']} "
                  f"score {pred['score']} tta {pred.get('tta', '-')}  "
                  f"{latency * 1e3:.1f} ms  {'ok' if acc == 1.0 else 'WRONG'}", flush=True)
        print(f"  transcribe {LONG_CLIP} ({long_latency * 1e3:.1f} ms): "
              f"{len(long_text.split())} words", flush=True)
        print(f"  forwards {forwards}; launches {launches}; per forward: int4 "
              f"{launches['int4_matmul'] / max(forwards, 1):g}, log-mel "
              f"{launches['log_mel'] / max(forwards, 1):g}; peak memory {peak} B", flush=True)
        wrong = [clip for clip, _p, _l, acc in results if acc != 1.0]
        if wrong:
            raise AssertionError(f"wrong predictions: {wrong}")
        if not long_text.strip():
            raise AssertionError(f"empty transcript for {LONG_CLIP}")
        if forwards == 0 or launches["int4_matmul"] != INT4_LAUNCHES_PER_FORWARD * forwards \
                or launches["log_mel"] != forwards:
            raise AssertionError("the main path did not run every kernel once per layer")
        for e in entries[:2]:
            e["launches"] = launches[e["name"]]

    with phase("plain path"):
        config, variables = load_variables(shipped_checkpoint())
        plain = EncoderRuntime(dataclasses.replace(config, use_pallas=False), variables, DEVICE)
        audio = load_audio(CORPUS / CLIPS[1])
        lp_k, ids_k, t_k = runtime.forward(audio)
        lp_p, ids_p, t_p = plain.forward(audio)
        if t_k != t_p:
            raise AssertionError(f"frame counts differ: {t_k} vs {t_p}")
        delta = float((lp_k[:t_k] - lp_p[:t_p]).abs().max())
        same = collapse_ctc(ids_k, runtime.blank_id) == collapse_ctc(ids_p, plain.blank_id)
        print(f"  {CLIPS[1]}: max|Δ log-prob| kernels vs plain ops {delta:.4g}; "
              f"collapsed ids equal: {same}", flush=True)
        if not same:
            raise AssertionError("kernel path and plain path decode differently")

    trace_clips = [(c, load_audio(CORPUS / c)) for c in (CLIPS[1], CLIPS[-1])]
    with phase("trace"):
        trace(torch, quant, runtime, recognizer, trace_clips)

    with phase("streaming"):
        stream_rt = load_runtime(STREAM_BUNDLE, DEVICE, long_chunking=False)
        stream_rec = Recognizer(stream_rt)
        if stream_rt.config.quant != "int8":
            raise AssertionError(f"{STREAM_BUNDLE} is not the int8 model")
        stream_rt.forward(load_audio(CORPUS / CLIPS[1]))       # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        stream_rt.forwards = 0
        stream_rt.forward(load_audio(CORPUS / CLIPS[1]))
        torch.cuda.synchronize()
        one = dict(kernels.LAUNCHES)
        print(f"  one stream6-int8 forward: launches {one}", flush=True)
        if one != {"int4_matmul": 0, "log_mel": 1, "int8_matmul": INT8_LAUNCHES_PER_FORWARD}:
            raise AssertionError("a stream6-int8 forward must launch 189 int8 and 1 log-mel kernels")
        audio = load_audio(CORPUS / CLIPS[1])
        fwd = []
        for _ in range(7):
            t = time.perf_counter()
            stream_rt.forward(audio)
            fwd.append((time.perf_counter() - t) * 1e3)
        fwd_ms = sorted(fwd)[len(fwd) // 2]
        print(f"  {CLIPS[1]} stream6-int8 forward: median of 7 {fwd_ms:.2f} ms (host clock, "
              f"ends in a host read)", flush=True)
        device_busy(torch, stream_rt, audio, fwd_ms, top=6)
        stream_launches = streaming(torch, kernels, rerank, validate_streaming, stream_rec)
        entries[2]["launches"] = stream_launches["int8_matmul"]

    with phase("cache"):
        cache_check(np, load_audio, stream_rt, StreamingEncoderCache)
        del stream_rt, stream_rec

    with phase("server"):
        serve(np, manifest)

    with phase("champion again"):
        for name, audio in trace_clips:
            fwd, pred = zip(*(host_ms(runtime, recognizer, audio) for _ in range(7)))
            print(f"  {name} after the streaming, cache and server phases: median of 7: "
                  f"forward {sorted(fwd)[3]:.2f} ms, predict {sorted(pred)[3]:.2f} ms",
                  flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: v for k, v in e.items() if k not in keys}}
        for e in entries
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def main() -> int:
    try:
        return run()
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED in {e}", file=sys.stderr, flush=True)
        return 1
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
