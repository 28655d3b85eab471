"""Port's streaming stack vs the JAX package's, on the CPU: the
RecitationTracker and RecitationSession replays, OracleRuntime,
choose_longest_stable_prefix, the micro-batch dispatcher (with the solo
bypass race closed), the WebSocket server and the validate_streaming
harness.

Both trackers are fed the same scripted TranscribeResult sequence whose
log-probs OracleRuntime renders from the scripted token ids (numpy, from a
seed), so the tracker's CTC fusion scoring runs on the JAX CTC scorer on
one side and on the port's on the other. Tolerance: the emitted messages
are identical, after rounding floats to 6 decimals (the CTC scores of the
two scorers agree to ~1e-6: f32 sums in another order).
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tilawa_tpu.data.quran import QuranDB as JaxQuranDB  # noqa: E402
from tilawa_tpu.data.token_store import TokenStore as JaxTokenStore  # noqa: E402
from tilawa_tpu.pipeline import rerank as jrerank  # noqa: E402
from tilawa_tpu.pipeline import runtime as jrt  # noqa: E402
from tilawa_tpu.streaming import session as jsession  # noqa: E402
from tilawa_tpu.streaming import tracker as jtracker  # noqa: E402
from tilawa_tpu.streaming.config import STREAMING_PRESETS as JAX_PRESETS  # noqa: E402
from tilawa_tpu_torch.data.quran import QuranDB  # noqa: E402
from tilawa_tpu_torch.data.token_store import TokenStore  # noqa: E402
from tilawa_tpu_torch.pipeline import rerank  # noqa: E402
from tilawa_tpu_torch.pipeline.runtime import OracleRuntime  # noqa: E402
from tilawa_tpu_torch.streaming import session, tracker  # noqa: E402
from tilawa_tpu_torch.streaming.config import CONSERVATIVE, STREAMING_PRESETS  # noqa: E402
from tilawa_tpu_torch.streaming.dispatcher import MicroBatchDispatcher  # noqa: E402
from tilawa_tpu_torch.streaming.tracker import TranscribeResult  # noqa: E402

SR = 16000


@pytest.fixture(scope="module")
def dbs():
    return QuranDB(), JaxQuranDB()


@pytest.fixture(scope="module")
def stores():
    return TokenStore.load_default(), JaxTokenStore.load_default()


def speech(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(SR * seconds)) * 0.1).astype(np.float32)


def silence(seconds):
    return np.zeros(int(SR * seconds), dtype=np.float32)


def _rounded(obj):
    if isinstance(obj, float):
        return round(obj, 6)
    if isinstance(obj, dict):
        return {k: _rounded(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_rounded(v) for v in obj]
    return obj


def _surah_112_words(db):
    first = db.get_verse(112, 1)["text_clean_no_bsm"]
    return " ".join([first] + [db.get_verse(112, a)["text_clean"] for a in range(2, 5)]).split()


def _recitation_decodes(db, store):
    """Window decodes of a recitation of surah 112 that grows a word per
    cycle: (text, token ids, log-probs, t_valid), the log-probs rendered
    from the ids with noise from a seed."""
    words = _surah_112_words(db)
    texts = [" ".join(words[:4])] * 3
    texts += [" ".join(words[:n]) for n in range(5, len(words) + 1)]
    texts += [" ".join(words)] * 3
    renderer = OracleRuntime(lambda *a: [], noise=0.3, seed=7)
    out = []
    for text in texts:
        ids = store.ids_for_text(text)
        lp, t = renderer.render_ids(ids)
        out.append((text, ids, lp, t))
    return out


def _feed_schedule():
    return [speech(2.1, 0), speech(2.1, 1)] + [speech(0.6, i) for i in range(2, 30)] + [silence(1.5)]


def _replay_tracker(module, db, store, decodes, config):
    state = {"i": 0}

    def transcribe(audio):
        text, ids, lp, t = decodes[min(state["i"], len(decodes) - 1)]
        state["i"] += 1
        return module.TranscribeResult(text=text, token_ids=list(ids), log_probs=lp, t_valid=t)

    events = []
    tr = module.RecitationTracker(transcribe, db=db, token_store=store, config=config,
                                  on_diagnostic=events.append)
    messages = []
    for chunk in _feed_schedule():
        messages.extend(tr.feed(chunk))
    return messages, events, state["i"]


@pytest.mark.parametrize("preset", ["conservative", "balanced", "aggressiveAdvance"])
def test_tracker_replay_matches_jax(dbs, stores, preset):
    (db, jdb), (store, jstore) = dbs, stores
    decodes = _recitation_decodes(db, store)
    for ours_d, ref_d in zip(decodes, _recitation_decodes(jdb, jstore), strict=True):
        assert ours_d[:2] == ref_d[:2]   # the copied tokenizer and store agree
    ours, our_events, our_calls = _replay_tracker(
        tracker, db, store, decodes, STREAMING_PRESETS[preset])
    ref, ref_events, ref_calls = _replay_tracker(
        jtracker, jdb, jstore, decodes, JAX_PRESETS[preset])
    assert our_calls == ref_calls > 0
    assert _rounded(ours) == _rounded(ref)
    assert _rounded(our_events) == _rounded(ref_events)
    types = {m["type"] for m in ours}
    assert "verse_match" in types
    matched = [(m["surah"], m["ayah"]) for m in ours if m["type"] == "verse_match"]
    assert matched[0] == (112, 1) and (112, 4) in matched


def test_tracker_decodes_through_fusion_scoring(dbs, stores, monkeypatch):
    """The replay above reaches the port's CTC scorer with the rendered
    log-probs (the tracker's acoustic fusion), not only text matching."""
    (db, _), (store, _) = dbs, stores
    calls = []
    real = rerank.score_token_lists

    def counting(*args, **kw):
        calls.append(len(args[2]))
        return real(*args, **kw)

    monkeypatch.setattr(rerank, "score_token_lists", counting)
    _replay_tracker(tracker, db, store, _recitation_decodes(db, store), CONSERVATIVE)
    assert calls and sum(calls) > 0


def test_session_replay_matches_jax(dbs):
    db, jdb = dbs
    words = _surah_112_words(db)
    texts = [" ".join(words[:4])] * 2 + [" ".join(words[:n]) for n in range(5, len(words) + 1)]
    texts += ["كلمات غير موجودة"]

    def backend():
        state = {"i": 0}

        def transcribe(audio):
            t = texts[min(state["i"], len(texts) - 1)]
            state["i"] += 1
            return t

        return transcribe

    chunks = [speech(1.0, i) for i in range(24)] + [silence(2.0), speech(1.0, 99)]
    out = {}
    for name, module, d in (("ours", session, db), ("ref", jsession, jdb)):
        s = module.RecitationSession(backend(), db=d)
        out[name] = [m for c in chunks for m in s.feed(c)]
    assert _rounded(out["ours"]) == _rounded(out["ref"])
    assert any(m["type"] == "verse_match" for m in out["ours"])


def test_oracle_runtime_matches_jax(stores):
    store, _ = stores
    ids = store.ids_for_key(112, 1)
    for kw in ({}, {"error_rate": 0.2, "noise": 0.5, "seed": 3}):
        lp, t = OracleRuntime(lambda *a: ids, **kw).render([(112, 1, None)])
        lp_ref, t_ref = jrt.OracleRuntime(lambda *a: ids, **kw).render([(112, 1, None)])
        assert t == t_ref
        np.testing.assert_array_equal(lp, lp_ref)


@pytest.mark.parametrize("tolerance", [0.0, 0.12, 5.0])
def test_choose_longest_stable_prefix_matches_jax(stores, tolerance):
    store, _ = stores
    ids = store.ids_for_key(112, 1) + store.ids_for_key(112, 2)
    lp, t = OracleRuntime(lambda *a: [], noise=0.4, seed=1).render_ids(ids)
    prefixes = [ids[:n] for n in range(1, len(ids) + 1)] + [[], ids * 20]
    for arg in (lp, torch.from_numpy(rerank.pad_frames(lp)[0])):
        got = rerank.choose_longest_stable_prefix(arg, t, prefixes, tolerance)
        assert got == jrerank.choose_longest_stable_prefix(lp, t, prefixes, tolerance)
    assert rerank.choose_longest_stable_prefix(lp, t, []) is None


# ------------------------------------------------------------- dispatcher


class FakeRuntime:
    blank_id = 1024

    def __init__(self, delay=0.0, probe=None):
        self.batch_calls: list[int] = []
        self.delay, self.probe = delay, probe

    def forward_batch_async(self, waves):
        if self.probe:
            self.probe.enter()
        time.sleep(self.delay)
        if self.probe:
            self.probe.leave()
        b, t = len(waves), 4
        self.batch_calls.append(b)
        packed = np.concatenate(
            [np.full((b, 1), t, np.int32), np.full((b, t), self.blank_id, np.int32)], axis=1
        )
        return torch.zeros((b, t, 8)), torch.from_numpy(packed)


class FakeTokenizer:
    @staticmethod
    def decode(ids):
        return ""


class Probe:
    """Counts how many threads are inside the recognizer at once."""

    def __init__(self):
        self.active = 0
        self.most = 0
        self.lock = threading.Lock()

    def enter(self):
        with self.lock:
            self.active += 1
            self.most = max(self.most, self.active)

    def leave(self):
        with self.lock:
            self.active -= 1


class FakeRecognizer:
    def __init__(self, delay=0.0, probe=None):
        self.runtime = FakeRuntime(delay, probe)
        self.tokenizer = FakeTokenizer()
        self.single_calls = 0
        self.delay, self.probe = delay, probe

    def transcribe_result(self, audio):
        if self.probe:
            self.probe.enter()
        time.sleep(self.delay)
        self.single_calls += 1
        if self.probe:
            self.probe.leave()
        return TranscribeResult(text="solo")


def test_concurrent_requests_coalesce():
    rec = FakeRecognizer()
    d = MicroBatchDispatcher(rec, max_batch=8, max_wait_ms=300.0)
    d.session_started()
    d.session_started()  # two sessions -> queue path

    results = {}
    barrier = threading.Barrier(2)

    def worker(name):
        barrier.wait()
        results[name] = d.transcribe_result(np.zeros(16000, np.float32))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 2
    for r in results.values():
        assert isinstance(r, TranscribeResult) and isinstance(r.log_probs, torch.Tensor)
    assert rec.runtime.batch_calls == [2]
    assert d.coalesced_requests == 2
    assert rec.single_calls == 0


def test_solo_session_bypasses_queue():
    rec = FakeRecognizer()
    d = MicroBatchDispatcher(rec)
    d.session_started()
    out = d.transcribe_result(np.zeros(8000, np.float32))
    assert out.text == "solo"
    assert rec.single_calls == 1
    assert rec.runtime.batch_calls == []


def test_solo_bypass_does_not_overlap_a_batch():
    """A second session connects while a solo request is mid-decode: the
    dispatcher thread's work waits for the solo call to leave the
    recognizer instead of running beside it."""
    probe = Probe()
    rec = FakeRecognizer(delay=0.3, probe=probe)
    d = MicroBatchDispatcher(rec, max_batch=8, max_wait_ms=50.0)
    d.session_started()
    solo = threading.Thread(target=d.transcribe_result, args=(np.zeros(8000, np.float32),))
    solo.start()
    deadline = time.monotonic() + 10
    while probe.active == 0 and time.monotonic() < deadline:
        time.sleep(0.001)       # until the solo call is inside the recognizer
    assert probe.active == 1
    d.session_started()         # a second session arrives
    barrier = threading.Barrier(2)
    others = [threading.Thread(target=lambda: (barrier.wait(), d.transcribe_result(
        np.zeros(16000, np.float32)))) for _ in range(2)]
    for t in others:
        t.start()
    for t in [solo, *others]:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in [solo, *others])
    assert rec.single_calls + sum(rec.runtime.batch_calls) == 3   # each served once
    assert probe.most == 1


def test_two_ws_clients_served_concurrently(dbs):
    from tilawa_tpu_torch.streaming import ws as wslib
    from tilawa_tpu_torch.streaming.server import RecitationServer

    db, _ = dbs

    class ScriptedBackend:
        def transcribe_result(self, audio):
            return TranscribeResult(text="قل هو الله احد")

    async def scenario():
        server = RecitationServer(ScriptedBackend(), db=db)
        assert server.dispatcher is not None
        srv = await wslib.serve(server.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]

        async def client():
            sock = await wslib.connect("127.0.0.1", port)
            audio = speech(3.0)
            for start in range(0, len(audio), 4800):
                await sock.send_bytes(audio[start:start + 4800].tobytes())

            async def read_until_match():
                while True:
                    msg = await sock.receive()
                    if msg.is_text:
                        m = json.loads(msg.text)
                        if m.get("type") == "verse_match":
                            return m

            m = await asyncio.wait_for(read_until_match(), timeout=30)
            await sock.close()
            return m

        m1, m2 = await asyncio.gather(client(), client())
        for m in (m1, m2):
            assert (m["surah"], m["ayah"]) == (112, 1)
        srv.close()
        await srv.wait_closed()

    asyncio.run(scenario())


# ------------------------------------------------------------ WS server


def test_ws_roundtrip_verse_match(dbs):
    """A plain callable backend on the port's server: status, then a verse
    match streamed back over a real socket (tests/test_ws_server.py)."""
    from tilawa_tpu_torch.streaming import ws as wslib
    from tilawa_tpu_torch.streaming.server import RecitationServer

    db, _ = dbs

    async def scenario():
        server = RecitationServer(lambda audio: "قل هو الله احد", db=db)
        assert server.dispatcher is None
        srv = await wslib.serve(server.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        sock = await wslib.connect("127.0.0.1", port)
        await sock.send_text("status")
        status = json.loads((await sock.receive()).text)
        assert status["total_verses"] == 6236 and status["engine"] == "session"
        audio = speech(3.0)
        for start in range(0, len(audio), 4800):
            await sock.send_bytes(audio[start:start + 4800].tobytes())

        async def read_until_match():
            while True:
                msg = await sock.receive()
                if msg.is_text:
                    m = json.loads(msg.text)
                    if m["type"] == "verse_match":
                        return m

        m = await asyncio.wait_for(read_until_match(), timeout=30)
        assert (m["surah"], m["ayah"]) == (112, 1)
        assert any(v["is_current"] for v in m["surrounding_verses"])
        await sock.close()
        srv.close()
        await srv.wait_closed()

    asyncio.run(scenario())


def test_model_loader_rejects_bad_sha(tmp_path, monkeypatch):
    """The port's loader verifies the bundle against export_metadata.json
    before it builds anything."""
    from tilawa_tpu_torch.streaming.server import ModelLoader

    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "variables.msgpack").write_bytes(b"\x80")
    (tmp_path / "export_metadata.json").write_text(
        json.dumps({"files": {"variables.msgpack": {"sha256": "0" * 64}}}))
    monkeypatch.setenv("TILAWA_CHECKPOINT", str(tmp_path))
    loader = ModelLoader(warmup=False, device="cpu")
    loader._load()
    assert loader.state["phase"] == "error" and "sha256" in loader.state["error"]
    assert not loader.ready


# ------------------------------------------------------ validate_streaming


def test_run_validation_matches_jax_on_scripted_backend(dbs, stores):
    """The port's harness and the JAX package's, on one v1 clip with the
    same scripted backend: the same emissions and scores."""
    from tilawa_tpu.eval import validate_streaming as jvs
    from tilawa_tpu_torch.eval import validate_streaming as vs

    (db, jdb), (store, jstore) = dbs, stores
    text = db.get_verse(1, 2)["text_clean"]

    def backend(module):
        return lambda audio: module.TranscribeResult(text=text, token_ids=[1, 2, 3])

    ids = {"retasy_003"}
    ours = vs.run_validation(backend(tracker), ids=ids, db=db, token_store=store, verbose=False)
    ref = jvs.run_validation(backend(jtracker), ids=ids, db=jdb, token_store=jstore, verbose=False)
    assert ours["total"] == ref["total"] == 1
    for key in ("recall", "precision", "sequence_accuracy", "viterbi_sequence_accuracy"):
        assert ours[key] == ref[key]
    assert ours["sequence_accuracy"] == 1.0
    assert ours["per_sample"][0]["predicted"] == ref["per_sample"][0]["predicted"]
    assert vs.load_manifest("v1")[0] == jvs.load_manifest("v1")[0]
