"""Micro-batched multi-session transcribe dispatcher (port of
tilawa_tpu/streaming/dispatcher.py).

The reference serializes WebSocket clients behind ONE asyncio transcribe
lock (reference: web/server.py:569, 716-719) because one CPU model = one
stream of forwards. The card's parallelism lives on the batch axis:
concurrent sessions' decode windows that land in the same audio bucket are
coalesced here into ONE [B, bucket] batched forward, so N live streams cost
~one stream's forward cadence instead of N serialized forwards.

Mechanics: sessions call `transcribe_result(audio)` from their own feed
threads; requests enter a queue consumed by a single dispatcher thread.
The dispatcher drains whatever is waiting (up to `max_batch`), groups by
bucket, pads the batch dimension to a power of two (a handful of compiled
programs per bucket, not one per batch size), runs
`EncoderRuntime.forward_batch_async` per group, then finishes each
request host-side (CTC collapse -> BPE decode -> normalize). When only
one session is registered the queue is bypassed — a solo stream keeps the
exact single-stream latency path.

The recognizer (its runtime and its StreamingEncoderCache) is used by one
thread at a time: the solo bypass and the dispatcher thread's batches both
hold `_rec_lock`. Without it, a second session connecting while a solo
request is mid-decode lets the dispatcher thread forward concurrently on
the same recognizer.

The window TTA (pipeline/predict.py STREAM_TTA) runs only where a request
reaches `Recognizer.transcribe_result`: a solo request, and the singles of
a batch (long windows, a batch of one). A coalesced group is finished here
from one plain row per request, with no perturbed row. The JAX package
routes the same way (tilawa_tpu/streaming/dispatcher.py:104-190), and the
port matches it.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np


def _pow2_pad(n: int, cap: int) -> int:
    p = 1
    while p < n and p < cap:
        p *= 2
    return p


class _Request:
    __slots__ = ("audio", "event", "result", "error")

    def __init__(self, audio: np.ndarray):
        self.audio = audio
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None


class MicroBatchDispatcher:
    """Wraps a Recognizer (or a ModelLoader exposing `.recognizer`) with a
    coalescing transcribe front end for multi-session serving."""

    def __init__(
        self,
        recognizer,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
    ):
        self._rec_or_loader = recognizer
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: queue.Queue[_Request] = queue.Queue()
        self._sessions = 0
        self._sessions_lock = threading.Lock()
        self._rec_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.batches_dispatched = 0
        self.requests_served = 0
        self.coalesced_requests = 0

    # -- the ModelLoader surface the server reads ------------------------
    @property
    def state(self):
        return getattr(self._rec_or_loader, "state", None)

    @property
    def model_size_bytes(self):
        return getattr(self._rec_or_loader, "model_size_bytes", 0)

    @property
    def weights(self):
        return getattr(self._rec_or_loader, "weights", "")

    def _recognizer(self):
        rec = getattr(self._rec_or_loader, "recognizer", None)
        return rec if rec is not None else self._rec_or_loader

    # -- session bookkeeping ---------------------------------------------
    def session_started(self) -> None:
        with self._sessions_lock:
            self._sessions += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="microbatch-dispatch"
                )
                self._thread.start()

    def session_ended(self) -> None:
        with self._sessions_lock:
            self._sessions = max(0, self._sessions - 1)

    # -- the transcribe surface ------------------------------------------
    def __call__(self, audio: np.ndarray):
        return self.transcribe_result(audio)

    def transcribe_result(self, audio: np.ndarray):
        rec = self._recognizer()
        with self._sessions_lock:
            solo = self._sessions <= 1
        if solo:
            # no coalescing partner possible: skip the queue
            with self._rec_lock:
                self.requests_served += 1
                if hasattr(rec, "transcribe_result"):
                    return rec.transcribe_result(audio)
                return rec(audio)  # loader not fully resolved yet
        req = _Request(np.asarray(audio, dtype=np.float32))
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    # -- dispatcher thread ------------------------------------------------
    def _loop(self) -> None:
        while True:
            req = self._q.get()
            batch = [req]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                with self._rec_lock:
                    self._run_batch(batch)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for r in batch:
                    if not r.event.is_set():
                        r.error = e
                        r.event.set()

    def _run_batch(self, batch: list[_Request]) -> None:
        from tilawa_tpu_torch.pipeline.runtime import LONG_THRESHOLD, bucket_length

        rec = self._recognizer()
        runtime = getattr(rec, "runtime", None)
        self.batches_dispatched += 1
        self.requests_served += len(batch)
        if len(batch) > 1:
            self.coalesced_requests += len(batch)

        # Long windows (or runtimes without batched forwards) take the
        # per-request path — the StreamingEncoderCache handles >16 s
        # windows with content-addressed chunk reuse.
        singles: list[_Request] = []
        groups: dict[int, list[_Request]] = {}
        batched_ok = hasattr(runtime, "forward_batch_async")
        for r in batch:
            if (
                not batched_ok
                or len(r.audio) > LONG_THRESHOLD
                or len(batch) == 1
            ):
                singles.append(r)
            else:
                groups.setdefault(bucket_length(len(r.audio)), []).append(r)

        # Queue every group's forward before fetching any (the launches
        # are asynchronous: the host reads the ids once per group after all
        # groups are queued).
        inflight = []
        for bucket in sorted(groups):
            reqs = groups[bucket]
            waves = [r.audio for r in reqs]
            pad_to = _pow2_pad(len(waves), self.max_batch)
            while len(waves) < pad_to:
                waves.append(np.zeros(bucket, np.float32))
            inflight.append(
                (reqs, *runtime.forward_batch_async(waves))
            )
        for r in singles:
            try:
                r.result = rec.transcribe_result(r.audio)
            except BaseException as e:  # noqa: BLE001
                r.error = e
            r.event.set()
        for reqs, lp_dev, packed_dev in inflight:
            packed = packed_dev.cpu().numpy()
            t_valids, ids_b = packed[:, 0], packed[:, 1:]
            for j, r in enumerate(reqs):
                try:
                    r.result = self._finish(
                        rec, lp_dev[j], ids_b[j], int(t_valids[j])
                    )
                except BaseException as e:  # noqa: BLE001
                    r.error = e
                r.event.set()

    @staticmethod
    def _finish(rec, lp_row, ids_row, t_valid):
        from tilawa_tpu_torch.data.normalizer import normalize_arabic
        from tilawa_tpu_torch.ops.ctc import collapse_ctc
        from tilawa_tpu_torch.streaming.tracker import TranscribeResult

        deduped = collapse_ctc(ids_row[:t_valid], rec.runtime.blank_id)
        text = (
            normalize_arabic(rec.tokenizer.decode(deduped).strip())
            if deduped else ""
        )
        return TranscribeResult(
            text=text,
            token_ids=list(deduped),
            log_probs=lp_row,
            t_valid=t_valid,
        )
