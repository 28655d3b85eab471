"""The port's training data against the JAX package's: the same seed gives
bitwise the same batches (numpy only on both sides), the same forced
alignments and the same distillation crops. Tolerance: none (bit equality)."""

import numpy as np
import pytest

from tilawa_tpu.train import align as jalign
from tilawa_tpu.train import data as jdata
from tilawa_tpu.train import distill as jdistill
from tilawa_tpu_torch.train import align as talign
from tilawa_tpu_torch.train import data as tdata
from tilawa_tpu_torch.train import distill as tdistill

IDS = {"retasy_000", "retasy_003", "retasy_008", "retasy_014", "multi_036_001_005",
       "long_033_056"}


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def test_corpus_batches_bitwise():
    j = jdata.corpus_batches(batch_size=3, seed=4, max_audio_s=6.0)
    t = tdata.corpus_batches(batch_size=3, seed=4, max_audio_s=6.0)
    for _ in range(4):
        _equal(next(j), next(t))


@pytest.mark.parametrize("kw", [
    dict(seed=0, crop_prob=0.35, only_ids=IDS),
    dict(seed=3, crop_prob=0.35, only_ids=IDS, aug_strength="strong", weighting="sqrt"),
], ids=["base", "strong"])
def test_bucketed_corpus_batches_bitwise(kw):
    j = jdata.bucketed_corpus_batches(corpora=("v1",), **kw)
    t = tdata.bucketed_corpus_batches(corpora=("v1",), **kw)
    for _ in range(6):
        _equal(next(j), next(t))


def test_viterbi_align_and_alignments_equal():
    rng = np.random.default_rng(0)
    for t_len, tokens in ((40, [3, 5, 5, 2]), (9, [1, 2, 3, 4, 5]), (4, [2, 2, 2]), (30, [])):
        lp = np.log(rng.dirichlet(np.ones(7), size=t_len)).astype(np.float32)
        a, b = jalign.viterbi_align(lp, tokens, 6), talign.viterbi_align(lp, tokens, 6)
        assert (a is None and b is None) or np.array_equal(a, b)
    ja, ta = jalign.load_alignments("v1"), talign.load_alignments("v1")
    assert ja.keys() == ta.keys() and len(ta) > 30
    for cid in ja:
        assert ja[cid].keys() == ta[cid].keys()
        for k in ja[cid]:
            assert np.array_equal(ja[cid][k], ta[cid][k])


def test_snap_crop_equal():
    entry = talign.load_alignments("v1")["multi_036_001_005"]
    ids = list(entry["token_ids"])
    spans = np.stack([entry["starts"], entry["ends"]], axis=1)
    n = int(entry["ends"][-1]) + 4000
    audio = np.zeros(n, np.float32)
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(50):
        a = jdistill.snap_crop(audio, ids, spans, rj)
        b = tdistill.snap_crop(audio, ids, spans, rt)
        assert a == b
        assert a[0] % tdistill.FRAME_STRIDE == 0


def test_distill_batches_bitwise():
    j = jdistill.distill_batches(corpora=("v1",), seed=2)
    t = tdistill.distill_batches(corpora=("v1",), seed=2)
    for _ in range(3):
        _equal(next(j), next(t))
