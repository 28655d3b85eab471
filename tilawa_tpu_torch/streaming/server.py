"""WebSocket recitation server on the PyTorch runtime (port of
tilawa_tpu/streaming/server.py; reference: web/server.py rebuilt on the
stdlib WS layer + transport-free streaming engines).

    python -m tilawa_tpu_torch.streaming.server --port 8765 --engine tracker

serves the shipped checkpoint (TILAWA_CHECKPOINT, else exports/champion-int4)
on the CUDA card; --device cpu runs the plain ops on the CPU.

Protocol (parity with the reference worker/server message surface):
  binary frames    raw float32 PCM 16 kHz mono chunks
  "status"         → {"type": "status", ...}      (REST /api/status twin)
  {"type":"reset"}                                 rebuild the engine state
  {"type":"set_config", "preset"|knobs...}         live config update
                     (reference: worker set_config, inference.ts:65-69)
  {"type":"set_debug","enabled":true}              stream tracker diagnostic
                     events as {"type":"debug",...} (inference.ts:31-39)
Replies: verse_match / word_progress / raw_transcript / debug JSON.

Engines:
  tracker  — full RecitationTracker (browser brain: discovery/tracking FSM,
             acoustic fusion, deferred emission; lib/tracker.ts)
  session  — server-flavored RecitationSession (web/server.py FSM)

A real model backend sits behind the micro-batch dispatcher; a plain
callable (tests) is serialized with an asyncio lock like the reference's
single transcribe lock (server.py:569). The REST/static surface (/, /api/*, /admin) rides the same port via
ApiService.
"""

from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np

from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.streaming import ws as wslib


class RecitationServer:
    def __init__(self, transcribe, db: QuranDB | None = None,
                 storage_dir: str = "storage", backend: str = "real",
                 engine: str = "session", micro_batch: bool = True):
        from tilawa_tpu_torch.streaming.api import ApiService

        self.dispatcher = None
        if micro_batch and (
            hasattr(transcribe, "recognizer")
            or hasattr(transcribe, "transcribe_result")
        ):
            # Real model backends get the micro-batching front end:
            # concurrent sessions' decode windows coalesce into one
            # bucketed dispatch instead of serializing behind a global
            # lock (the reference's design, web/server.py:569).
            from tilawa_tpu_torch.streaming.dispatcher import MicroBatchDispatcher

            self.dispatcher = MicroBatchDispatcher(transcribe)
            transcribe = self.dispatcher
        self.transcribe = transcribe
        self.db = db or QuranDB()
        self.engine = engine
        # plain-callable backends (tests, mocks) keep the serialized path
        self._lock = asyncio.Lock() if self.dispatcher is None else None
        self.api = ApiService(db=self.db, storage_dir=storage_dir,
                              backend=backend,
                              model_state=lambda: self._model_state())

    def _model_state(self) -> dict:
        state = getattr(self.transcribe, "state", None)
        if state is None:
            state = {"phase": "ready", "progress": 1.0, "ready": True}
        if self.dispatcher is not None:
            state = dict(state)
            state["micro_batch"] = {
                "batches_dispatched": self.dispatcher.batches_dispatched,
                "requests_served": self.dispatcher.requests_served,
                "coalesced_requests": self.dispatcher.coalesced_requests,
            }
        return state

    def _make_engine(self, debug_sink):
        if self.engine == "tracker":
            from tilawa_tpu_torch.streaming.tracker import (
                RecitationTracker,
                TranscribeResult,
            )

            def as_result(audio: np.ndarray) -> TranscribeResult:
                out = self.transcribe(audio)
                if isinstance(out, TranscribeResult):
                    return out
                return TranscribeResult(text=out or "")

            return RecitationTracker(
                as_result, db=self.db, on_diagnostic=debug_sink
            )
        from tilawa_tpu_torch.streaming.session import RecitationSession

        def as_text(audio: np.ndarray) -> str:
            out = self.transcribe(audio)
            return out if isinstance(out, str) else out.text

        return RecitationSession(as_text, db=self.db)

    async def handle(self, sock: wslib.WebSocket, path: str) -> None:
        if self.dispatcher is not None:
            self.dispatcher.session_started()
            try:
                await self._handle(sock, path)
            finally:
                self.dispatcher.session_ended()
        else:
            await self._handle(sock, path)

    async def _handle(self, sock: wslib.WebSocket, path: str) -> None:
        loop = asyncio.get_event_loop()
        debug_on = False
        debug_events: list[dict] = []

        def debug_sink(event: dict) -> None:
            if debug_on:
                debug_events.append(event)

        engine = self._make_engine(debug_sink)
        while True:
            msg = await sock.receive()
            if msg.is_text:
                text = msg.text.strip()
                if text == "status":
                    await sock.send_text(json.dumps(
                        {"type": "status", "ok": True, "engine": self.engine,
                         "total_verses": self.db.total_verses,
                         "model": self._model_state(),
                         "model_size_bytes": getattr(
                             self.transcribe, "model_size_bytes", 0),
                         "weights": getattr(self.transcribe, "weights", "")}))
                    continue
                try:
                    cmd = json.loads(text)
                except json.JSONDecodeError:
                    continue
                ctype = cmd.get("type")
                if ctype == "reset":
                    engine = self._make_engine(debug_sink)
                    await sock.send_text(json.dumps({"type": "reset_done"}))
                elif ctype == "set_config" and hasattr(engine, "set_config"):
                    partial = {k: v for k, v in cmd.items() if k != "type"}
                    preset = partial.pop("preset", None)
                    if preset is not None:
                        from tilawa_tpu_torch.streaming.config import STREAMING_PRESETS

                        base = STREAMING_PRESETS.get(preset)
                        if base is not None:
                            engine.set_config(base)
                    if partial:
                        try:
                            engine.set_config(partial)
                        except (ValueError, TypeError) as e:
                            await sock.send_text(json.dumps(
                                {"type": "error", "error": str(e)}))
                elif ctype == "set_debug":
                    debug_on = bool(cmd.get("enabled", True))
                continue
            samples = np.frombuffer(msg.data, dtype=np.float32)
            model = self._model_state()
            if not model.get("ready"):
                # Audio before the model is up: report load progress
                # instead of silently eating frames (reference: the UI
                # renders model-cache download progress before the worker
                # accepts audio, model-cache.ts:38-70).
                await sock.send_text(json.dumps(
                    {"type": "model_loading", **model}))
                continue
            if self._lock is not None:
                # plain-callable backend: serialize across sessions
                # (the reference's global transcribe lock, server.py:569)
                async with self._lock:
                    out = await loop.run_in_executor(None, engine.feed, samples)
            else:
                # micro-batched backend: sessions feed concurrently; the
                # dispatcher coalesces their decode windows on the card.
                # Per-session ordering holds because each connection's
                # frames are processed sequentially in this loop.
                out = await loop.run_in_executor(None, engine.feed, samples)
            for event in debug_events:
                await sock.send_text(json.dumps(
                    {"type": "debug", "event": event}, ensure_ascii=False,
                    default=str))
            debug_events.clear()
            for m in out:
                await sock.send_text(json.dumps(m, ensure_ascii=False))


class ModelLoader:
    """Background model initialization with observable progress.

    The reference streams its 88 MB ONNX into IndexedDB with a per-chunk
    progress callback the UI renders as a download bar
    (reference: worker/model-cache.ts:38-70, main.ts model status). Here
    the model lives server-side, so the analogue is load progress of the
    weight bundle: sha-verify → deserialize → device upload → per-bucket
    warmup, published through /api/status and as `model_loading` WS
    replies until ready. The HTTP/WS surface comes up immediately; audio
    fed before readiness gets progress messages instead of silence."""

    def __init__(self, warmup: bool = True, device: str = "cuda"):
        self.device = device
        self.state: dict = {"phase": "starting", "progress": 0.0,
                            "ready": False}
        self.recognizer = None  # set when loaded; micro-batch target
        self.model_size_bytes = 0
        self.weights = ""
        self._fn = None
        self.warmup = warmup

    def _set(self, phase: str, progress: float, **extra) -> None:
        self.state = {"phase": phase, "progress": round(progress, 3),
                      "ready": phase == "ready", **extra}

    def start(self) -> "ModelLoader":
        import threading

        t = threading.Thread(target=self._load, daemon=True)
        t.start()
        return self

    def _load(self) -> None:
        try:
            import hashlib

            from tilawa_tpu_torch.io.bundle import load_variables, shipped_checkpoint
            from tilawa_tpu_torch.pipeline.predict import Recognizer
            from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime

            ckpt = shipped_checkpoint()
            if not ckpt:
                # the port runs trained bundles only (no random init)
                self._set("error", 0.0, error="no export bundle found "
                                              "(set TILAWA_CHECKPOINT)")
                return
            blob = ckpt / "variables.msgpack"
            total = blob.stat().st_size if blob.exists() else 0
            self._set("verify", 0.0, bytes_total=total, weights=str(ckpt))
            # Chunked sha256 so progress is real, not performative —
            # checked against export_metadata.json when present
            # (reference: inference.ts:114-117 sha-verified assets).
            h = hashlib.sha256()
            done = 0
            with open(blob, "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    h.update(chunk)
                    done += len(chunk)
                    self._set("verify", done / max(total, 1),
                              bytes_total=total, weights=str(ckpt))
            meta = ckpt / "export_metadata.json"
            if meta.exists():
                # Bundle schema stores hashes under
                # files["variables.msgpack"]["sha256"] (train/export.py);
                # a bundle whose metadata lacks the hash is surfaced as
                # an error rather than silently passing verification.
                want = (
                    json.loads(meta.read_text())
                    .get("files", {})
                    .get("variables.msgpack", {})
                    .get("sha256")
                )
                if not want:
                    self._set("error", 0.0,
                              error="export_metadata.json missing "
                                    "variables.msgpack sha256")
                    return
                if want != h.hexdigest():
                    self._set("error", 0.0,
                              error="bundle sha256 mismatch")
                    return
            self._set("load", 0.0, weights=str(ckpt))
            config, variables = load_variables(ckpt)
            runtime = EncoderRuntime(config, variables, device=self.device)
            recognizer = Recognizer(runtime)
            self.recognizer = recognizer  # micro-batch dispatcher target
            self.model_size_bytes = recognizer.model_size()
            self.weights = str(ckpt)
            if self.warmup:
                buckets = (64000, 128000, 256000)
                for i, n in enumerate(buckets):
                    self._set("warmup", i / len(buckets), bucket=n)
                    runtime.forward(np.zeros(n, dtype=np.float32))
            self._fn = recognizer.transcribe_result
            self._set("ready", 1.0)
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            self._set("error", 0.0, error=str(e))

    @property
    def ready(self) -> bool:
        return self._fn is not None

    def __call__(self, audio):
        if self._fn is None:
            raise RuntimeError(f"model not ready: {self.state}")
        return self._fn(audio)


def _real_transcribe(warmup: bool = True, device: str = "cuda") -> ModelLoader:
    return ModelLoader(warmup=warmup, device=device).start()


async def _amain(host: str, port: int, backend: str, engine: str,
                 warmup: bool = True, device: str = "cuda"):
    if backend == "real":
        transcribe = _real_transcribe(warmup=warmup, device=device)
    else:
        raise SystemExit(f"unknown backend {backend!r}")
    server = RecitationServer(transcribe, backend=backend, engine=engine)
    srv = await wslib.serve(server.handle, host, port,
                            http_handler=server.api.handle)
    print(f"tilawa-tpu (PyTorch) WS server on ws://{host}:{port}/ws "
          f"(engine={engine}; app: http://{host}:{port}/, REST: /api/status, "
          f"/api/surah/{{n}}, /api/reports, /api/diagnostics, /admin)")
    async with srv:
        await srv.serve_forever()


def main():
    parser = argparse.ArgumentParser(description="tilawa-tpu streaming server (PyTorch port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--backend", default="real")
    parser.add_argument("--engine", default="session",
                        choices=["tracker", "session"])
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip encoder warmup (CPU smoke runs)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu for the plain ops")
    args = parser.parse_args()
    asyncio.run(_amain(args.host, args.port, args.backend, args.engine,
                       warmup=not args.no_warmup, device=args.device))


if __name__ == "__main__":
    main()
