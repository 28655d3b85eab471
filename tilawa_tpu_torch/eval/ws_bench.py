"""Live WS endpoint benchmark: replay corpus audio against a running
server and score the emitted verse sequence.

Port of tilawa_tpu/eval/ws_bench.py (reference:
scripts/benchmark_streaming_endpoint.py — replay at 300 ms chunks plus a
4 s silence tail so the final-flush path fires, score with
score_sequence), with a per-message latency.

Per-message latency: the server answers a connection's frames in order,
each audio chunk's messages right after that chunk's feed. After every
audio chunk the client sends the text frame "status", whose reply marks
the end of that chunk's messages. A message's latency is its arrival time
minus the send time of the chunk it answers; with chunks sent flat out
(the default) it includes the server's backlog, with --realtime it is the
delay behind live audio. The replay ends when the last chunk's marker
arrives.

Usage (server already running, e.g. `python -m
tilawa_tpu_torch.streaming.server --engine tracker`):
  python -m tilawa_tpu_torch.eval.ws_bench --port 8765 --corpus v1 --limit 5
  python -m tilawa_tpu_torch.eval.ws_bench --clients 2 --limit 4
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np

from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
from tilawa_tpu_torch.eval.metrics import score_sequence
from tilawa_tpu_torch.eval.runner import load_manifest
from tilawa_tpu_torch.streaming import ws as wslib

SAMPLE_RATE = 16000
CHUNK_SECONDS = 0.3
TAIL_SILENCE_SECONDS = 4.0
MARKER = "status"       # the server replies {"type": "status", ...} in order


async def run_sample(
    host: str, port: int, audio: np.ndarray, realtime: bool = False,
    timeout_s: float = 120.0,
) -> tuple[list[dict], float, list[float]]:
    """Stream one clip; returns (messages without the markers' replies,
    arrival time of the last of them, per-message latencies in s)."""
    sock = await wslib.connect(host, port)
    chunk = int(SAMPLE_RATE * CHUNK_SECONDS)
    padded = np.concatenate(
        [audio, np.zeros(int(SAMPLE_RATE * TAIL_SILENCE_SECONDS), np.float32)]
    )
    n_chunks = -(-len(padded) // chunk)
    sent: list[float] = []
    messages: list[dict] = []
    latencies: list[float] = []
    last_msg_t = [time.perf_counter()]
    done = asyncio.Event()

    async def reader():
        answered = 0      # chunks whose marker has arrived
        try:
            while answered < n_chunks:
                msg = await sock.receive()
                if not msg.is_text:
                    continue
                m = json.loads(msg.text)
                now = time.perf_counter()
                if m.get("type") == "status":
                    answered += 1
                    continue
                messages.append(m)
                latencies.append(now - sent[answered])
                last_msg_t[0] = now
        except wslib.ConnectionClosed:
            pass
        finally:
            done.set()

    task = asyncio.create_task(reader())
    try:
        for i in range(0, len(padded), chunk):
            sent.append(time.perf_counter())
            await sock.send_bytes(padded[i:i + chunk].astype(np.float32).tobytes())
            await sock.send_text(MARKER)
            if realtime:
                await asyncio.sleep(CHUNK_SECONDS)
        await asyncio.wait_for(done.wait(), timeout=timeout_s)
    finally:
        await sock.close()
        await asyncio.wait_for(task, timeout=5)
    return messages, last_msg_t[0], latencies


def emissions_from_messages(messages: list[dict]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for m in messages:
        if m.get("type") == "verse_rollback":
            end = m.get("ayah_end") or m["ayah"]
            refs = {(m["surah"], a) for a in range(m["ayah"], end + 1)}
            out = [r for r in out if r not in refs]
        elif m.get("type") == "verse_match":
            end = m.get("ayah_end") or m["ayah"]
            for a in range(m["ayah"], end + 1):
                ref = (m["surah"], a)
                if ref not in out:
                    out.append(ref)
    return out


def _pct(values: list[float], q: float) -> float | None:
    if not values:
        return None
    v = sorted(values)
    return round(v[min(len(v) - 1, int(q * (len(v) - 1)))], 4)


async def replay(
    host: str, port: int, loaded: list[tuple[dict, np.ndarray]],
    clients: int = 1, realtime: bool = False,
) -> dict:
    """Stream `loaded` (sample, audio) pairs through `clients` concurrent
    connections, one clip at a time each. In real time a client keeps pace
    when it finishes within its audio's duration + the tail + 3 s
    (realtime_ok; None when chunks go flat out)."""
    queue: asyncio.Queue = asyncio.Queue()
    for item in loaded:
        queue.put_nowait(item)
    rows: list[dict] = []
    all_latencies: list[float] = []

    async def client():
        while not queue.empty():
            s, audio = queue.get_nowait()
            t0 = time.perf_counter()
            messages, last_t, latencies = await run_sample(host, port, audio, realtime)
            wall = last_t - t0
            duration = len(audio) / SAMPLE_RATE + TAIL_SILENCE_SECONDS
            expected = s.get("expected_verses", [{"surah": s["surah"], "ayah": s["ayah"]}])
            got = emissions_from_messages(messages)
            sc = score_sequence(expected, [{"surah": g[0], "ayah": g[1]} for g in got])
            all_latencies.extend(latencies)
            rows.append({
                "id": s["id"], "wall_s": round(wall, 2), "audio_s": round(duration, 2),
                "realtime_ok": wall <= duration + 3.0 if realtime else None,
                "sequence_accuracy": sc["sequence_accuracy"], "recall": sc["recall"],
                "precision": sc["precision"], "expected": [(e["surah"], e["ayah"]) for e in expected],
                "got": got, "messages": len(messages),
                "message_latency_p50_s": _pct(latencies, 0.5),
                "message_latency_p90_s": _pct(latencies, 0.9),
            })

    t0 = time.perf_counter()
    await asyncio.gather(*(client() for _ in range(max(1, clients))))
    wall = time.perf_counter() - t0
    n = len(rows)
    return {
        "n": n,
        "clients": clients,
        "realtime": realtime,
        "all_realtime_ok": all(r["realtime_ok"] for r in rows) if realtime else None,
        "wall_s": round(wall, 2),
        **{k: round(sum(r[k] for r in rows) / n, 4) if n else 0.0
           for k in ("recall", "precision", "sequence_accuracy")},
        "n_messages": len(all_latencies),
        "message_latency_p50_s": _pct(all_latencies, 0.5),
        "message_latency_p90_s": _pct(all_latencies, 0.9),
        "per_client": rows,
    }


def load_clips(samples: list[dict], corpus_dir, limit: int) -> list[tuple[dict, np.ndarray]]:
    """The first `limit` decodable samples (all with limit 0)."""
    loaded = []
    for s in samples:
        path = corpus_dir / s["file"]
        if not path.exists():
            continue
        try:
            loaded.append((s, load_audio(path)))
        except UnsupportedAudioFormat:
            continue
        if limit and len(loaded) >= limit:
            break
    return loaded


async def amain(args) -> dict:
    samples, corpus_dir = load_manifest(args.corpus)
    if args.category:
        samples = [s for s in samples if s["category"] == args.category]
    # --clients N without --limit streams N clips, one per client
    limit = args.limit or (args.clients if args.clients > 1 else 0)
    loaded = load_clips(samples, corpus_dir, limit)
    result = await replay(args.host, args.port, loaded, args.clients, args.realtime)
    for r in result["per_client"]:
        print(f"  {r['id']}: expected {r['expected']} got {r['got']} "
              f"seq_acc={r['sequence_accuracy']:.2f}")
    print(json.dumps({k: v for k, v in result.items() if k != "per_client"}))
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description="live WS endpoint benchmark")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--corpus", default="v1")
    parser.add_argument("--category", default=None)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--realtime", action="store_true",
                        help="pace chunks at real time instead of flat out")
    parser.add_argument("--clients", type=int, default=1,
                        help="concurrent connections (the server's micro-batch "
                             "dispatcher coalesces their decode windows)")
    args = parser.parse_args(argv)
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
