"""The port's remaining champion-bundle experiment families and their host
modules against the JAX package's, on the CPU.

* text/ngram.py: NGramLM log-probs (sentence_logp, perplexity) exactly
  equal over the first 300 verses of the corpus and over shuffled ones
  (same float64 arithmetic); lm_rescore's fused scores and order equal.
* text/trie.py and ops/beam.py: TokenTrie's CSR arrays and refs equal;
  beam_search_decode's hypotheses (ids, float64 scores, refs) equal on
  seeded oracle log-probs.
* the registry: on two short v1 clips, the greedy transcripts of
  pruned-ctc (L6-first_n), two-stage, fastconformer-quran-lm-fusion and
  heldout equal the JAX package's (its experiments with use_pallas=False,
  as the other parity tests run the champion), and so do their (surah,
  ayah, ayah_end) but for a near tie: where the reference's best
  candidate leads its runner-up by less than the largest score difference
  of the two packages' common candidates on that clip (their bf16 rounding
  points differ, ROADMAP C.3), the port may pick a candidate within that
  difference of the reference's best. The un-fine-tuned L6 prune scores
  every candidate near -13 and meets this on retasy_002 (ROADMAP C.6).
  On the 41 s multi_114_001_006 LM fusion picks other verses than JAX: its
  greedy ids differ at two frames whose top-two gap is under the packages'
  log-prob difference (ROADMAP C.9, LONG_NEAR_TIE).
  The random-init fallbacks of the JAX package raise here; the runner's
  --list expands pruned-ctc as the JAX runner's does.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from tilawa_tpu_torch.eval import experiments as texp  # noqa: E402
from tilawa_tpu_torch.eval import runner as trunner  # noqa: E402
from tilawa_tpu_torch.io.bundle import EXPORTS_DIR  # noqa: E402

CORPUS = EXPORTS_DIR.parent / "benchmark" / "test_corpus"
CLIPS = ("retasy_000.wav", "retasy_002.wav")
KEY = ("surah", "ayah", "ayah_end")
FAMILIES = ("pruned-ctc", "two-stage", "fastconformer-quran-lm-fusion", "heldout")


# ------------------------------------------------------------------ n-gram

@pytest.fixture(scope="module")
def lms():
    from tilawa_tpu.text.ngram import NGramLM as JaxLM
    from tilawa_tpu_torch.text.ngram import NGramLM

    return NGramLM.from_corpus_file(order=5), JaxLM.from_corpus_file(order=5)


def _corpus_lines() -> list[str]:
    from tilawa_tpu_torch.data.assets import default_asset_path

    return [ln.strip() for ln in
            default_asset_path("kenlm/quran_corpus.txt").read_text(encoding="utf-8").splitlines()
            if ln.strip()]


def test_ngram_log_probs_equal_jax(lms):
    ours, ref = lms
    assert ours.total_words == ref.total_words and ours.vocab == ref.vocab
    lines = _corpus_lines()
    rng = np.random.default_rng(0)
    shuffled = [" ".join(rng.permutation(ln.split())) for ln in
                (lines[i] for i in rng.choice(len(lines), 100, replace=False))]
    for line in lines[:300] + shuffled + ["كلمة غريبة جدا"]:
        words = line.split()
        assert ours.sentence_logp(words) == ref.sentence_logp(words), line
        assert ours.perplexity(words) == ref.perplexity(words), line
    assert ours.logp("الله", ("بسم",)) == ref.logp("الله", ("بسم",))


def test_lm_rescore_order_equals_jax(lms):
    from tilawa_tpu.text.ngram import lm_rescore as jax_rescore
    from tilawa_tpu_torch.text.ngram import lm_rescore

    lines = _corpus_lines()
    rng = np.random.default_rng(1)
    for _ in range(20):
        idx = rng.choice(len(lines), 6, replace=False)
        hyps = [{"surah": int(i), "ayah": 1, "text": lines[i],
                 "score": float(rng.uniform(0, 1))} for i in idx]
        hyps.append({"surah": 0, "ayah": 0, "text": "", "score": 0.5})
        ours = lm_rescore(hyps, lms[0], 0.7, 1.0)
        ref = jax_rescore(hyps, lms[1], 0.7, 1.0)
        assert [(h["surah"], h["fused_score"], h["lm_logp"]) for h in ours] == \
            [(h["surah"], h["fused_score"], h["lm_logp"]) for h in ref]


# ------------------------------------------------------------ trie + beam

def _verse_sequences(n: int = 400):
    from tilawa_tpu_torch.data.token_store import TokenStore

    store = TokenStore.load_default()
    out = []
    for surah in range(1, 115):
        for ayah in range(1, 300):
            ids = store.ids_for_key(surah, ayah)
            if ids is None:
                break
            out.append((list(ids), (surah, ayah, None)))
            if len(out) == n:
                return out
    return out


@pytest.fixture(scope="module")
def tries():
    from tilawa_tpu.text.trie import TokenTrie as JaxTrie
    from tilawa_tpu_torch.text.trie import TokenTrie

    seqs = _verse_sequences()
    return seqs, TokenTrie.build(seqs), JaxTrie.build(seqs)


def test_token_trie_arrays_equal_jax(tries):
    seqs, ours, ref = tries
    for name in ("edge_start", "edge_count", "edge_token", "edge_child",
                 "end_start", "end_count"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.end_refs == ref.end_refs
    assert ours.memory_bytes() == ref.memory_bytes()
    for ids, key in seqs[:50]:
        node = ours.walk(ids)
        assert node == ref.walk(ids) and key in ours.refs_at(node)


def test_build_verse_trie_equals_jax():
    from types import SimpleNamespace

    from tilawa_tpu.text.trie import build_verse_trie as jax_build
    from tilawa_tpu_torch.text.trie import build_verse_trie

    rng = np.random.default_rng(2)
    vocab = [f"p{i}" for i in range(69)]
    refs = {(1 + i // 7, 1 + i % 7): " ".join(rng.choice(vocab, rng.integers(1, 30)))
            for i in range(200)}
    store = SimpleNamespace(refs=refs, vocab=vocab)
    ours, ref = build_verse_trie(store), jax_build(store)
    np.testing.assert_array_equal(ours.edge_token, ref.edge_token)
    np.testing.assert_array_equal(ours.edge_child, ref.edge_child)
    assert ours.end_refs == ref.end_refs


@pytest.mark.parametrize("seed,noise", [(0, 0.3), (1, 1.0), (2, 2.0)])
def test_beam_search_equals_jax(tries, seed, noise):
    from tilawa_tpu.ops.beam import beam_search_decode as jax_beam
    from tilawa_tpu_torch.ops.beam import beam_search_decode
    from tilawa_tpu_torch.pipeline.runtime import OracleRuntime

    seqs, ours_trie, ref_trie = tries
    rng = np.random.default_rng(seed)
    ids = seqs[int(rng.integers(len(seqs)))][0]
    renderer = OracleRuntime(lambda *a: [], noise=noise, error_rate=0.05, seed=seed)
    lp, t = renderer.render_ids(ids)
    ours = beam_search_decode(lp, 1024, ours_trie, beam_width=8, t_valid=t)
    ref = jax_beam(lp, 1024, ref_trie, beam_width=8, t_valid=t)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert (a.token_ids, a.score, a.matched_refs, a.is_complete) == \
            (b.token_ids, b.score, b.matched_refs, b.is_complete)


# -------------------------------------------------------------- families

@pytest.fixture(scope="module")
def family_decisions():
    """Each family's predictions on CLIPS, the JAX package's (its own
    experiment classes, every model loaded with use_pallas=False) and the
    port's on the CPU."""
    import tilawa_tpu.train.checkpoint as jckpt
    from tilawa_tpu.eval import experiments as jexp

    real_load = jckpt.load_variables

    def load_plain(path):
        config, variables = real_load(path)
        return dataclasses.replace(config, use_pallas=False), variables

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "load_variables", load_plain)
        jax_exps = {
            "pruned-ctc": jexp.PrunedCTCExperiment(),
            "two-stage": jexp.TwoStageExperiment(),
            "fastconformer-quran-lm-fusion": jexp.LMFusionExperiment(error_rate=0.10, noise=1.0),
            "heldout": jexp._REGISTRY["heldout"](),
        }
        jax_exps["pruned-ctc"].set_model("L6-first_n")
        for name, exp in jax_exps.items():
            out[name] = {clip: [exp.predict(str(CORPUS / clip))] for clip in CLIPS}
    for name in FAMILIES:
        exp = texp.get_experiment(name, device="cpu")
        if name == "pruned-ctc":
            exp.set_model("L6-first_n")
        for clip in CLIPS:
            out[name][clip].append(exp.predict(str(CORPUS / clip)))
    return out


def _near_tie(ref: dict, ours: dict) -> bool:
    """The port's pick is within the packages' score difference of the
    reference's best, and that difference exceeds the reference's margin."""
    def scores(result):
        key = "fused_score" if "fused_score" in (result["candidates"] or [{}])[0] else "score"
        return {tuple(c[k] for k in KEY): c[key] for c in result["candidates"]}

    a, b = scores(ref), scores(ours)
    common = set(a) & set(b)
    delta = max(abs(a[k] - b[k]) for k in common) if common else 0.0
    ranked = sorted(a.values(), reverse=True)
    pick = tuple(ours[k] for k in KEY)
    return (len(ranked) > 1 and ranked[0] - ranked[1] < delta
            and pick in a and a[pick] >= ranked[0] - delta)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("clip", CLIPS)
def test_family_decisions_equal_jax(family_decisions, name, clip):
    ref, ours = family_decisions[name][clip]
    assert ours["transcript"] == ref["transcript"]
    if tuple(ours[k] for k in KEY) != tuple(ref[k] for k in KEY):
        assert _near_tie(ref, ours), (ref, ours)
    if name == "two-stage":
        assert ours["stage1_transcript"] == ref["stage1_transcript"]
    if name == "fastconformer-quran-lm-fusion":
        assert [tuple(c[k] for k in KEY) for c in ours["candidates"]] == \
            [tuple(c[k] for k in KEY) for c in ref["candidates"]]
    if name == "heldout":
        assert ours.get("tta") == ref.get("tta")


# ROADMAP C.9: on the 41 s multi_114_001_006 the port's LM-fusion pick (114:3-6)
# differs from JAX's and its record's (114:4-6). The champion's greedy ids
# differ at 2 of 519 frames, where JAX's top-two gap is 0.193 and 0.192, under
# the packages' max|Δ log-prob| on the clip (0.815): one word of the transcript
# splits differently, retrieval builds other candidates, and the pick follows.
LONG_NEAR_TIE = ("multi_114_001_006.wav", [185, 292])


def test_long_clip_greedy_near_tie():
    from tilawa_tpu.pipeline.runtime import EncoderRuntime as JaxRuntime
    from tilawa_tpu.train.checkpoint import load_variables as jax_load
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.jax_refs import LP_TOL, greedy

    clip, frames = LONG_NEAR_TIE
    config, variables = jax_load(EXPORTS_DIR / "champion-int4")
    jrt = JaxRuntime(dataclasses.replace(config, use_pallas=False), variables)
    audio = load_audio(CORPUS / clip)
    jlp, jt = jrt.log_probs(audio)
    lp, t = texp.get_experiment("fastconformer-quran-lm-fusion", device="cpu").real \
        .runtime.log_probs(audio)
    a, b = greedy(lp, t), greedy(np.asarray(jlp), jt)
    delta = float(np.abs(lp[:t] - np.asarray(jlp)[:t]).max())
    assert t == jt == 519
    assert [i for i, (x, y) in enumerate(zip(a["ids"], b["ids"])) if x != y] == frames
    assert [b["gaps"][i] for i in frames] == pytest.approx([0.193, 0.192], abs=1e-3)
    assert delta == pytest.approx(0.815, abs=1e-3) and delta <= LP_TOL


def test_family_shapes_and_labels():
    lm = texp.get_experiment("fastconformer-quran-lm-fusion", device="cpu")
    assert lm.acoustics == "real" and lm.model_size() > 0
    pruned = texp.get_experiment("pruned-ctc", device="cpu")
    assert pruned.list_models() == sorted(texp.PrunedCTCExperiment.VARIANTS)
    pruned.set_model("L6-first_n")
    assert pruned.runtime.config.num_layers == len(pruned.runtime.model.blocks) == 6
    with pytest.raises(KeyError):
        pruned.set_model("L5-first_n")
    stage1, stage2 = texp.get_experiment("two-stage", device="cpu").stages
    assert (stage1.runtime.config.num_layers, stage2.runtime.config.num_layers) == (12, 17)
    assert stage2.rerank_mode == "always"
    heldout = texp.get_experiment("heldout", device="cpu")
    assert heldout.tta and heldout.runtime.config.quant == "int4"


def test_random_init_fallbacks_raise(monkeypatch, tmp_path):
    """Where the JAX package builds a random-init model, the port raises."""
    monkeypatch.setattr(texp, "shipped_checkpoint", lambda: None)
    monkeypatch.delenv("TILAWA_STAGE1_CHECKPOINT", raising=False)
    with pytest.raises(FileNotFoundError):
        texp.PrunedCTCExperiment(device="cpu").predict(str(CORPUS / CLIPS[0]))
    with pytest.raises(FileNotFoundError):
        texp.TwoStageExperiment(device="cpu").predict(str(CORPUS / CLIPS[0]))
    monkeypatch.setattr(texp, "EXPORTS_DIR", tmp_path)
    monkeypatch.setattr(texp, "CHECKPOINT_DIR", tmp_path)
    monkeypatch.delenv("TILAWA_HELDOUT_CKPT", raising=False)
    with pytest.raises(FileNotFoundError):
        texp._REGISTRY["heldout"]("cpu")
    # LM fusion without weights is the JAX package's labelled simulation
    assert texp.LMFusionExperiment(device="cpu").acoustics == "oracle"


def test_runner_list_expands_variants(capsys):
    from tilawa_tpu.eval import runner as jrunner

    trunner.main(["--list"])
    ours = capsys.readouterr().out.split()
    jrunner.main(["--list"])
    ref = capsys.readouterr().out.split()
    assert ours == ref


def test_runner_model_selects_a_variant(capsys):
    trunner.main(["--experiment", "pruned-ctc", "--model", "L6-first_n", "--device", "cpu",
                  "--no-save", "--category", "short"])
    out = capsys.readouterr().out
    assert "pruned-ctc" in out and "NOT saved" in out
    assert texp.get_experiment("pruned-ctc", "cpu").runtime.config.num_layers == 6
