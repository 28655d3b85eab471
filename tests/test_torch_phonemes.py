"""The port's phoneme store and aligner against the JAX package's, on the CPU.

tilawa_tpu_torch/data/phonemes.py and text/phonemes.py are copies of host
code, so every method must give the JAX package's result exactly (no
tolerance): the aligner (align_phonemes, align_phoneme_strings,
word_corrections) and PhonemeStore (vocab, references, encode_phonemes,
verse_ids, match_verse, ngram_vote, reference_phonemes, decode_ids,
decode_logprobs, detect_mispronunciations). Inputs: reference strings,
copies corrupted from a numpy seed, multi-verse spans, and empty and short
strings; the cases of tests/test_phonemes.py and tests/test_phoneme_train.py.
"""

import numpy as np
import pytest

from tilawa_tpu.data.phonemes import PhonemeStore as JaxStore
from tilawa_tpu.text import phonemes as jalign
from tilawa_tpu_torch.data.phonemes import PhonemeStore
from tilawa_tpu_torch.text import phonemes as talign

VERSES = ((1, 1), (1, 2), (2, 255), (36, 1), (103, 1), (112, 1), (114, 6))
SPANS = ((112, 1, 4), (36, 1, 5), (103, 1, 2), (1, 1, 7))


@pytest.fixture(scope="module")
def stores():
    return PhonemeStore.load_default(), JaxStore.load_default()


def corrupt(text: str, seed: int, rate: float = 0.15) -> str:
    """`text` with a seeded share of its phonemes substituted, dropped or
    doubled (word boundaries kept)."""
    rng = np.random.default_rng(seed)
    vocab = sorted({t for t in text.split() if t != "|"}) or ["a"]
    out = []
    for tok in text.split():
        r = rng.random()
        if tok == "|" or r >= rate:
            out.append(tok)
        elif r < rate / 3:
            out.append(vocab[int(rng.integers(len(vocab)))])
        elif r < 2 * rate / 3:
            continue
        else:
            out.extend([tok, vocab[int(rng.integers(len(vocab)))]])
    return " ".join(out)


def _texts(store) -> list[str]:
    refs = [store.reference_phonemes(s, a) for s, a in VERSES]
    spans = [store.reference_phonemes(*s) for s in SPANS]
    return (refs + spans + [corrupt(t, i) for i, t in enumerate(refs + spans)]
            + ["", " ", "b", "b i", "b i s m", "| |", "b i | s m"])


PAIRS = (
    ("b i s m", "b i s m"), ("b u s", "b i s"), ("b s", "b i s"), ("b i x s", "b i s"),
    ("", ""), ("a b", ""), ("", "a b"), ("a l a", "a ll a"),
    ("b i | s u m", "b i | s a m"), ("b a | t a m", "b i | s u m"), ("b i", "b i | s m"),
)


def _pairs(store) -> list[tuple[str, str]]:
    refs = [store.reference_phonemes(s, a) for s, a in VERSES] + \
        [store.reference_phonemes(*s) for s in SPANS]
    return list(PAIRS) + [(corrupt(r, 100 + i, 0.3), r) for i, r in enumerate(refs)] + \
        [(refs[i + 1], refs[i]) for i in range(len(refs) - 1)]


def test_alignment_equals_jax(stores):
    for pred, ref in _pairs(stores[0]):
        ours = talign.align_phoneme_strings(pred, ref)
        theirs = jalign.align_phoneme_strings(pred, ref)
        assert ours.to_dict() == theirs.to_dict(), (pred, ref)
        p, r = pred.split(), ref.split()
        assert talign.align_phonemes(p, r).to_dict() == jalign.align_phonemes(p, r).to_dict()


@pytest.mark.parametrize("max_word_index", [None, 0, 1, 3])
def test_word_corrections_equal_jax(stores, max_word_index):
    for pred, ref in _pairs(stores[0]):
        assert talign.word_corrections(pred, ref, max_word_index) == \
            jalign.word_corrections(pred, ref, max_word_index), (pred, ref)


def test_store_tables_equal_jax(stores):
    ours, theirs = stores
    assert ours.vocab == theirs.vocab
    assert (ours.blank_id, ours.num_classes) == (theirs.blank_id, theirs.num_classes) == (69, 70)
    assert ours.refs == theirs.refs and len(ours.refs) == 6236


def test_encode_and_reference_equal_jax(stores):
    ours, theirs = stores
    for text in _texts(ours):
        assert ours.encode_phonemes(text) == theirs.encode_phonemes(text)
    for s, a in VERSES:
        assert ours.reference_phonemes(s, a) == theirs.reference_phonemes(s, a)
        assert ours.verse_ids(s, a) == theirs.verse_ids(s, a)
    for s, a, e in (*SPANS, (112, 2, 2), (112, 3, 1), (1, 999, None)):
        assert ours.reference_phonemes(s, a, e) == theirs.reference_phonemes(s, a, e)
        assert ours.verse_ids(s, a, e) == theirs.verse_ids(s, a, e)


@pytest.mark.parametrize("top_k", [1, 5, 40])
def test_match_verse_equals_jax(stores, top_k):
    ours, theirs = stores
    texts = _texts(ours)
    texts += [t[:60] for t in texts] + [t[:120] for t in texts]
    for text in texts:
        assert ours.match_verse(text, top_k) == theirs.match_verse(text, top_k), text


@pytest.mark.parametrize("n", [3, 5])
def test_ngram_vote_equals_jax(stores, n):
    ours, theirs = stores
    for text in _texts(ours):
        assert ours.ngram_vote(text, n=n) == theirs.ngram_vote(text, n=n), text
        assert ours.ngram_vote(text[:160], n=n) == theirs.ngram_vote(text[:160], n=n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_equals_jax(stores, seed):
    ours, theirs = stores
    rng = np.random.default_rng(seed)
    lp = rng.standard_normal((64, ours.num_classes)).astype(np.float32)
    lp[rng.random(64) < 0.5, ours.blank_id] += 4.0
    for t_valid in (None, 1, 17, 64):
        assert ours.decode_logprobs(lp, t_valid) == theirs.decode_logprobs(lp, t_valid)
    ids = rng.integers(0, ours.num_classes + 2, 200)
    assert ours.decode_ids(ids) == theirs.decode_ids(ids)
    assert ours.decode_ids(list(ids)) == theirs.decode_ids(list(ids))
    assert ours.decode_ids([]) == theirs.decode_ids([]) == ""


@pytest.mark.parametrize("max_word_index", [None, 2])
def test_detect_mispronunciations_equals_jax(stores, max_word_index):
    ours, theirs = stores
    cases = [(s, a, None) for s, a in VERSES] + list(SPANS) + [(1, 999, None)]
    for i, (s, a, e) in enumerate(cases):
        ref = ours.reference_phonemes(s, a, e) or "b i"
        for pred in (ref, corrupt(ref, 200 + i, 0.2), "", "b"):
            assert ours.detect_mispronunciations(pred, s, a, e, max_word_index) == \
                theirs.detect_mispronunciations(pred, s, a, e, max_word_index), (s, a, e, pred)
