"""WS smoke client: stream a wav file in 300 ms chunks and print server
messages (reference: web/test_ws_audio.py — 4800-sample chunks)."""

from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np

from tilawa_tpu_torch.data.audio import load_audio
from tilawa_tpu_torch.streaming import ws as wslib

CHUNK = 4800  # 300 ms at 16 kHz


async def stream_file(
    path: str, host: str = "127.0.0.1", port: int = 8765,
    tail_silence_s: float = 4.0, realtime: bool = False,
    wait_s: float = 1.0,
) -> list[dict]:
    audio = load_audio(path)
    tail = np.zeros(int(tail_silence_s * 16000), dtype=np.float32)
    audio = np.concatenate([audio, tail])

    sock = await wslib.connect(host, port)
    messages: list[dict] = []

    async def reader():
        try:
            while True:
                msg = await sock.receive()
                if msg.is_text:
                    m = json.loads(msg.text)
                    messages.append(m)
                    print(f"<- {m.get('type')}: "
                          f"{ {k: v for k, v in m.items() if k not in ('surrounding_verses', 'verse_text')} }")
        except wslib.ConnectionClosed:
            pass

    task = asyncio.create_task(reader())
    for start in range(0, len(audio), CHUNK):
        await sock.send_bytes(audio[start : start + CHUNK].astype(np.float32).tobytes())
        if realtime:
            await asyncio.sleep(CHUNK / 16000)
        else:
            await asyncio.sleep(0.01)
    # Grace period before close: the server's first transcribe may still be
    # compiling (remote-TPU first-window compiles take minutes) — closing
    # early silently drops every message.
    await asyncio.sleep(wait_s)
    await sock.close()
    await task
    return messages


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("wav")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--realtime", action="store_true")
    parser.add_argument("--wait", type=float, default=1.0,
                        help="seconds to wait for trailing messages before close")
    args = parser.parse_args()
    asyncio.run(stream_file(args.wav, args.host, args.port,
                            realtime=args.realtime, wait_s=args.wait))


if __name__ == "__main__":
    main()
