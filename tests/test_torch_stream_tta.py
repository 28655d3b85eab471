"""The port's streaming window TTA (TILAWA_STREAM_TTA) against the JAX
package's, on the CPU.

* The small config (2 layers, d_model 64), f32, random JAX weights carried
  across by models/convert.py: Recognizer.transcribe_result of both
  packages with the switch on, on a seeded 1.2 s waveform. Equal token ids,
  text and t_valid, one two-row forward_batch each, and the kept row's
  log-probs within 1e-5 (the same f32 algorithm; tests/test_torch_model.py
  measured ~1e-5 on this config).
* The pick on a stub runtime whose rows decode to scripted ids, run through
  both packages' transcribe_result: the same row kept, the same forwards
  made. The switch's parsing, read from both modules' source as each
  package imports it.
* The dispatcher: a solo request reaches transcribe_result and forwards
  the window with its 0.9x variant; a coalesced batch forwards the raw
  windows only, as in the JAX package.
* An all-zero window's normalized features (ROADMAP C.11): rounding noise
  that differs between the packages, and the JAX package's under
  jax_refs.jax_silent_features.
The replay of v1 with the switch on is held to the JAX package's record in
tests/test_torch_refs.py.
"""

import importlib.util
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from tilawa_tpu.data.token_store import TokenStore as JaxTokenStore  # noqa: E402
from tilawa_tpu.models import fastconformer as jfc  # noqa: E402
from tilawa_tpu.pipeline import predict as jpredict  # noqa: E402
from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime  # noqa: E402
from tilawa_tpu_torch.data.audio import speed_perturb  # noqa: E402
from tilawa_tpu_torch.data.token_store import TokenStore  # noqa: E402
from tilawa_tpu_torch.models import fastconformer as tfc  # noqa: E402
from tilawa_tpu_torch.pipeline import predict  # noqa: E402
from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime  # noqa: E402
from tilawa_tpu_torch.streaming.dispatcher import MicroBatchDispatcher  # noqa: E402

SR = 16000
BLANK = 9
LP_ATOL = 1e-5


@pytest.fixture(scope="module")
def stores():
    return TokenStore.load_default(), JaxTokenStore.load_default()


@pytest.fixture
def tta_on(monkeypatch):
    monkeypatch.setattr(predict, "STREAM_TTA", True)
    monkeypatch.setattr(jpredict, "STREAM_TTA", True)


def _recognizers(port_runtime, jax_runtime, stores):
    store, jstore = stores
    return (predict.Recognizer(port_runtime, db=object(), token_store=store),
            jpredict.Recognizer(jax_runtime, db=object(), token_store=jstore))


def _count_rows(runtime, sink: list):
    """Record the row count of every forward_batch call of `runtime`."""
    real = runtime.forward_batch

    def counted(audios):
        sink.append(len(audios))
        return real(audios)

    runtime.forward_batch = counted


# ------------------------------------------------------------ small config


@pytest.mark.parametrize("seed", [0, 1])
def test_small_config_transcribe_result_matches_jax(stores, tta_on, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal(int(1.2 * SR)) * 0.1).astype(np.float32)
    jcfg = jfc.FastConformerConfig.small(use_pallas=False)
    jm = jfc.FastConformerCTC(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SR), jnp.float32), jnp.array([SR], jnp.int32)))
    rec, jrec = _recognizers(EncoderRuntime(tfc.FastConformerConfig.small(), variables, "cpu"),
                             JaxRuntime(jcfg, variables), stores)
    rows, jrows = [], []
    _count_rows(rec.runtime, rows)
    _count_rows(jrec.runtime, jrows)
    ours, ref = rec.transcribe_result(audio), jrec.transcribe_result(audio)
    assert rows == jrows == [2]
    assert ours.token_ids == ref.token_ids and ours.token_ids
    assert ours.text == ref.text
    assert ours.t_valid == ref.t_valid
    t = ref.t_valid
    np.testing.assert_allclose(ours.log_probs[:t].numpy(), np.asarray(ref.log_probs)[:t],
                               atol=LP_ATOL)


# ------------------------------------------------------------ silent windows


def test_silent_window_features_follow_jax_only_under_the_diagnostic():
    """ROADMAP C.11: the log-mel of an all-zero window is one constant, so
    its normalized features are 0 / 0 rounded: 1.0 everywhere in the JAX
    package on the CPU, and other values in the port. jax_silent_features
    gives such rows the JAX package's features and leaves a speech row
    bitwise as it was."""
    from tilawa_tpu.ops import frontend as jfront
    from tilawa_tpu_torch.eval.jax_refs import JAX_SILENT_FEATURE, jax_silent_features
    from tilawa_tpu_torch.ops import frontend

    silent = [16000, 16800, 23456, 33600, 45360, 50400, 57600, 64000]
    lengths = np.array(silent + [45360], np.int32)
    audio = np.zeros((len(lengths), 64000), np.float32)
    audio[-1, :45360] = np.random.default_rng(0).standard_normal(45360) * 0.1
    ref, ref_lens = jfront.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(lengths))
    ref = np.asarray(ref)
    args = (torch.from_numpy(audio), torch.from_numpy(lengths), frontend.mel_tables("cpu"))
    ours, lens = frontend.log_mel_spectrogram(*args, use_kernel=False)
    with jax_silent_features():
        fixed, _ = frontend.log_mel_spectrogram(*args, use_kernel=False)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    differ = 0
    for row, t in enumerate(lens.tolist()[: len(silent)]):
        assert np.all(ref[row, :t] == JAX_SILENT_FEATURE)
        np.testing.assert_array_equal(fixed[row, :t].numpy(), ref[row, :t])
        differ += not np.array_equal(ours[row, :t].numpy(), ref[row, :t])
    assert differ > 0                                                   # the fault
    assert torch.equal(fixed[-1], ours[-1])
    np.testing.assert_allclose(ours[-1].numpy(), ref[-1], atol=2e-4)   # test_torch_frontend.py's


# ------------------------------------------------------------ the pick


class StubRuntime:
    """A runtime whose forwards decode to scripted per-frame ids: the first
    row of every forward_batch to `window`, the second to `variant`. Each
    row's log-probs are filled with its row index, so the kept row shows."""

    blank_id = BLANK
    device = torch.device("cpu")

    def __init__(self, window, variant, long_chunking=False):
        self.rows_of = (np.asarray(window, np.int32), np.asarray(variant, np.int32))
        self.long_chunking = long_chunking
        self.calls: list[tuple[str, list[int]]] = []

    def forward_batch(self, audios):
        self.calls.append(("forward_batch", [len(a) for a in audios]))
        t = max(len(r) for r in self.rows_of)
        ids = np.full((len(audios), t), BLANK, np.int32)
        lens = np.zeros(len(audios), np.int32)
        for i in range(len(audios)):
            row = self.rows_of[min(i, 1)]
            ids[i, : len(row)] = row
            lens[i] = len(row)
        lps = np.stack([np.full((t, BLANK + 1), i, np.float32) for i in range(len(audios))])
        return lps, lens, ids

    def forward(self, audio):
        self.calls.append(("forward", [len(audio)]))
        lps, lens, ids = self.forward_batch([audio])
        self.calls.pop()
        return lps[0], ids[0, : lens[0]], int(lens[0])


def _ids(n_tokens: int) -> list[int]:
    """Per-frame ids that collapse to n_tokens tokens (token, blank, ...)."""
    return [x for k in range(n_tokens) for x in (k % BLANK, BLANK)]


class StubCache:
    def __init__(self, runtime):
        self.runtime = runtime

    def forward(self, audio):
        self.runtime.calls.append(("cache", [len(audio)]))
        return np.zeros((4, BLANK + 1), np.float32), np.array([1, BLANK, 2], np.int32), 3


def _both(stores, window, variant, audio, long_chunking=False):
    """transcribe_result of both packages over their own stub runtime:
    [(result, the runtime's calls)] for the port, then JAX."""
    out = []
    for make in _recognizers(StubRuntime(window, variant, long_chunking),
                             StubRuntime(window, variant, long_chunking), stores):
        make._stream_cache = StubCache(make.runtime) if long_chunking else None
        out.append((make.transcribe_result(audio), make.runtime.calls))
    return out


@pytest.mark.parametrize("d0,d1,kept", [(3, 5, 1), (0, 2, 1), (3, 4, 0), (3, 3, 0),
                                        (4, 2, 0)])
def test_pick_keeps_the_variant_only_past_one_token(stores, tta_on, d0, d1, kept):
    audio = np.full(SR, 0.01, np.float32)
    (ours, calls), (ref, jcalls) = _both(stores, _ids(d0), _ids(d1), audio)
    n_variant = len(speed_perturb(audio, 0.9))
    assert calls == jcalls == [("forward_batch", [SR, n_variant])]
    assert ours.token_ids == ref.token_ids == list(range(d1 if kept else d0))
    assert ours.t_valid == ref.t_valid == 2 * (d1 if kept else d0)
    assert ours.text == ref.text
    assert float(ours.log_probs[0, 0]) == float(ref.log_probs[0, 0]) == kept
    assert ours.log_probs.shape == ref.log_probs.shape   # the full bucket row


def test_short_audio_takes_one_plain_forward(stores, tta_on):
    audio = np.full(SR - 1, 0.01, np.float32)
    (ours, calls), (ref, jcalls) = _both(stores, _ids(2), _ids(6), audio)
    assert calls == jcalls == [("forward", [SR - 1])]
    assert ours.token_ids == ref.token_ids == [0, 1]


def test_long_chunking_takes_the_cache_with_the_switch_on(stores, tta_on):
    audio = np.full(3 * SR, 0.01, np.float32)
    (ours, calls), (ref, jcalls) = _both(stores, _ids(2), _ids(6), audio, long_chunking=True)
    assert calls == jcalls == [("cache", [3 * SR])]
    assert ours.token_ids == ref.token_ids == [1, 2]


def test_switch_off_takes_one_plain_forward(stores, monkeypatch):
    monkeypatch.setattr(predict, "STREAM_TTA", False)
    monkeypatch.setattr(jpredict, "STREAM_TTA", False)
    (ours, calls), (ref, jcalls) = _both(stores, _ids(2), _ids(6), np.full(2 * SR, 0.01,
                                                                           np.float32))
    assert calls == jcalls == [("forward", [2 * SR])]
    assert ours.token_ids == ref.token_ids == [0, 1]


def _switch_of(module, value, monkeypatch) -> bool:
    """STREAM_TTA of a fresh copy of `module` imported with
    TILAWA_STREAM_TTA=value (None: unset)."""
    if value is None:
        monkeypatch.delenv("TILAWA_STREAM_TTA", raising=False)
    else:
        monkeypatch.setenv("TILAWA_STREAM_TTA", value)
    spec = importlib.util.spec_from_file_location(f"{module.__name__}_copy", module.__file__)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    return copy.STREAM_TTA


@pytest.mark.parametrize("value,on", [(None, False), ("", False), ("0", False),
                                      ("false", False), ("1", True), ("true", True),
                                      ("yes", True)])
def test_switch_parses_as_in_jax(monkeypatch, value, on):
    assert _switch_of(predict, value, monkeypatch) is on
    assert _switch_of(jpredict, value, monkeypatch) is on


# ------------------------------------------------------------ the dispatcher


class AsyncStubRuntime(StubRuntime):
    """StubRuntime with the dispatcher's queued batch forward."""

    def forward_batch_async(self, audios):
        self.calls.append(("forward_batch_async", [len(a) for a in audios]))
        self.batches = getattr(self, "batches", []) + [[np.asarray(a) for a in audios]]
        t = 4
        packed = np.concatenate([np.full((len(audios), 1), t, np.int32),
                                 np.full((len(audios), t), BLANK, np.int32)], axis=1)
        return torch.zeros((len(audios), t, BLANK + 1)), torch.from_numpy(packed)


def _dispatcher(stores):
    store = stores[0]
    runtime = AsyncStubRuntime(_ids(2), _ids(6))
    rec = predict.Recognizer(runtime, db=object(), token_store=store)
    return MicroBatchDispatcher(rec, max_batch=8, max_wait_ms=300.0), runtime


def test_solo_request_forwards_the_variant(stores, tta_on):
    d, runtime = _dispatcher(stores)
    d.session_started()
    audio = np.full(SR, 0.01, np.float32)
    out = d.transcribe_result(audio)
    assert runtime.calls == [("forward_batch", [SR, len(speed_perturb(audio, 0.9))])]
    assert out.token_ids == list(range(6))


def test_coalesced_batch_forwards_no_perturbed_row(stores, tta_on):
    d, runtime = _dispatcher(stores)
    d.session_started()
    d.session_started()       # two sessions: the queue path
    audios = [np.full(SR, 0.01 * (i + 1), np.float32) for i in range(2)]
    results = {}
    barrier = threading.Barrier(2)

    def worker(i):
        barrier.wait()
        results[i] = d.transcribe_result(audios[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 2 and d.coalesced_requests == 2
    assert [name for name, _ in runtime.calls] == ["forward_batch_async"]
    (batch,) = runtime.batches
    assert len(batch) == 2      # the raw windows, in either order
    assert all(any(np.array_equal(row, a) for a in audios) for row in batch)
    assert not np.array_equal(batch[0], batch[1])
