"""The port's bench (python -m tilawa_tpu_torch.bench) on the CPU: its
schedule over two short v1 clips prints one JSON line with bench.py's keys
and the card keys, both clips right; without CUDA the default entry point
prints the line with an error and fails."""

import json

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from tilawa_tpu_torch import bench  # noqa: E402

KEYS = (
    "metric", "value", "unit", "vs_baseline", "baseline", "partial",
    "mean_latency_s", "p90_latency_s", "audio_sec_per_sec", "audio_sec_per_sec_batched",
    "recall", "seq_acc", "batched_recall", "batched_tta_clips", "batched_fetch_wait_s",
    "batched_decode_s", "batched_predict_s", "batched_wall_s", "model_size_bytes",
    "n_clips", "n_skipped_undecodable_or_absent", "device_init_s", "mfu_batched_e2e",
    "mfu_sequential", "device", "power_limit_w", "weights",
)


@pytest.fixture(scope="module")
def line():
    out = bench.new_line()
    mp = pytest.MonkeyPatch()
    mp.setenv("TILAWA_BATCHED_BS", "2")
    try:
        bench.run(out, bench.Budget(600), "cpu", ids={"retasy_000", "retasy_002"})
    finally:
        mp.undo()
    return out


def test_bench_line_has_every_key(line, capsys):
    bench.emit(line)
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    parsed = json.loads(printed[0])
    assert set(KEYS) <= set(parsed)
    assert "error" not in parsed and "batched_error" not in parsed


def test_bench_scores_the_clips(line):
    assert line["partial"] is False
    assert line["n_clips"] == 2 and line["n_skipped_undecodable_or_absent"] == 0
    assert line["recall"] == 1.0 and line["seq_acc"] == 1.0
    assert line["batched_recall"] == 1.0 and line["batched_tta_clips"] == 0
    assert line["metric"] == "p50_latency_s_per_clip_v1" and line["value"] > 0
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["model_size_bytes"] == 70054212


def test_bench_without_cuda_prints_an_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    parsed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "CUDA" in parsed["error"] and parsed["partial"] is True
