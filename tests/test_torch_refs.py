"""The port's JAX reference files (tilawa_tpu_torch/eval/jax_refs.py)
against the JAX package, on the CPU.

The files hold the JAX package's decisions over every decodable v1 clip:
validate_streaming on exports/stream6-int8 (300 ms chunks, the default
tracker config; and the same with the window TTA on, TILAWA_STREAM_TTA),
fastconformer-phoneme (exports/phoneme-int8, and oracle
acoustics with the CTC rerank off and on), heldout (exports/heldout-int4,
TTA) and the champion's greedy ids on the context-sweep rows at two audio
buckets, every model with use_pallas=False. chip_smoke's card gates compare
with them. Regenerate them with

    JAX_PLATFORMS=cpu python tests/test_torch_refs.py [streaming|streaming_tta|phoneme|heldout|sweep ...]

(a few minutes each on the CPU). The tests re-derive two short clips of
each live and hold them to the files (decisions, no tolerance), and hold
the port's streaming replay of the same clips on the CPU to both.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tilawa_tpu_torch.eval.jax_refs import (  # noqa: E402
    HELDOUT_REF,
    PHONEME_REF,
    STREAM_REF,
    STREAM_TTA_REF,
    SWEEP_REF,
    decision_row,
    jax_silent_features,
    load_ref,
    tta_lengths,
    tta_parting,
)
from tilawa_tpu_torch.eval.validate_streaming import CHUNK_SECONDS  # noqa: E402

STREAM6 = ROOT / "exports" / "stream6-int8"
SPOT_IDS = ("retasy_000", "retasy_002")
# section: TILAWA_PHONEME_RERANK
PHONEME_SECTIONS = {"real": "", "real_rerank": "1", "oracle": "", "oracle_rerank": "1"}


def load_stream_ref() -> dict[str, dict]:
    return load_ref(STREAM_REF)


def _verses(entries) -> list[list[int]] | None:
    return None if entries is None else [[e["surah"], e["ayah"]] for e in entries]


def _jax_stream6():
    """The JAX package's Recognizer on stream6-int8 with the plain ops."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tilawa_tpu.pipeline.predict import Recognizer
    from tilawa_tpu.pipeline.runtime import EncoderRuntime
    from tilawa_tpu.train.checkpoint import load_variables

    cfg, variables = load_variables(STREAM6)
    return Recognizer(EncoderRuntime(dataclasses.replace(cfg, use_pallas=False), variables))


def jax_validation(ids=None) -> dict:
    """The JAX package's validate_streaming on stream6-int8 with the plain
    ops, over `ids` (default: every decodable v1 clip)."""
    from tilawa_tpu.eval.validate_streaming import run_validation

    rec = _jax_stream6()
    return run_validation(rec.transcribe_result, corpus="v1", chunk_seconds=CHUNK_SECONDS,
                          ids=set(ids) if ids else None, db=rec.db,
                          token_store=rec.token_store, verbose=ids is None)


def tta_validation(rec, predict_module, run_validation, ids=None,
                   verbose: bool = False) -> tuple[dict, dict[str, dict]]:
    """`run_validation` over `rec.transcribe_result` with the window TTA on
    (predict_module.STREAM_TTA set for the call), and per clip its TTA
    cycles, read off the runtime's two-row forward_batch calls (the window
    and its 0.9x variant): {"kept": each cycle's [len(d0), len(d1)],
    "silent": the cycles whose window is all zeros}."""
    runtime = rec.runtime
    real = runtime.forward_batch
    pairs: dict[str, dict] = {}
    clip: list[str] = []

    def recording(audios):
        out = real(audios)
        if len(audios) == 2:
            cycles = pairs[clip[0]]
            if not np.any(audios[0]):
                cycles["silent"].append(len(cycles["kept"]))
            cycles["kept"].append(tta_lengths(out[1], out[2], runtime.blank_id))
        return out

    def per_clip(sample, _audio):
        clip[:] = [sample["id"]]
        pairs[sample["id"]] = {"kept": [], "silent": []}
        return rec.transcribe_result

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(predict_module, "STREAM_TTA", True)
        mp.setattr(runtime, "forward_batch", recording)
        result = run_validation(rec.transcribe_result, corpus="v1",
                                chunk_seconds=CHUNK_SECONDS, ids=set(ids) if ids else None,
                                db=rec.db, token_store=rec.token_store, verbose=verbose,
                                transcribe_factory=per_clip)
    return result, pairs


def jax_tta_validation(ids=None) -> tuple[dict, dict[str, dict]]:
    """jax_validation with the JAX package's window TTA on."""
    from tilawa_tpu.eval.validate_streaming import run_validation
    from tilawa_tpu.pipeline import predict

    return tta_validation(_jax_stream6(), predict, run_validation, ids, verbose=ids is None)


def rows_of(result: dict, pairs: dict[str, dict] | None = None) -> dict[str, dict]:
    """{clip id: the fields a gate compares}; with `pairs` (tta_validation's)
    also each clip's TTA cycles, their [len(d0), len(d1)] and its silent
    cycles."""
    return {
        r["id"]: {"predicted": _verses(r["predicted"]),
                  "final_sequence": _verses(r["final_sequence"]),
                  "sequence_accuracy": r["sequence_accuracy"],
                  **({} if pairs is None else
                     {"tta_cycles": len(pairs[r["id"]]["kept"]), **pairs[r["id"]]})}
        for r in result["per_sample"]
    }


def _write(path: Path, what: str, sections: dict[str, dict]) -> None:
    import jax

    path.write_text(json.dumps({"what": what, "jax": jax.__version__, **sections},
                               separators=(",", ":")) + "\n", encoding="utf-8")


def write_stream_ref(path: Path = STREAM_REF) -> None:
    result = jax_validation()
    _write(path, "the JAX package's validate_streaming over v1, exports/stream6-int8, "
           f"use_pallas=False, chunk {CHUNK_SECONDS} s, default tracker config, CPU",
           {"sequence_accuracy": result["sequence_accuracy"], "skipped": result["skipped"],
            "per_sample": rows_of(result)})


def write_stream_tta_ref(path: Path = STREAM_TTA_REF) -> None:
    result, pairs = jax_tta_validation()
    _write(path, "the JAX package's validate_streaming over v1, exports/stream6-int8, "
           f"use_pallas=False, chunk {CHUNK_SECONDS} s, default tracker config, the window "
           "TTA on (tilawa_tpu.pipeline.predict.STREAM_TTA), CPU",
           {"sequence_accuracy": result["sequence_accuracy"], "skipped": result["skipped"],
            "tta_cycles": sum(len(p["kept"]) for p in pairs.values()),
            "per_sample": rows_of(result, pairs)})


def jax_decisions(make, ids=None, rerank: str = "", oracle: bool = False) -> dict[str, dict]:
    """{clip id: decision_row} of the JAX experiment `make()` through the
    JAX runner over the v1 clips `ids` (default: all), every bundle loaded
    with use_pallas=False, with the greedy ids and gaps of every encoder row
    each prediction forwarded; oracle: as if no phoneme bundle existed."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tilawa_tpu.train.checkpoint as jckpt
    from tilawa_tpu.eval import experiments as jexp
    from tilawa_tpu.eval.runner import load_manifest, run_experiment

    real_load = jckpt.load_variables

    def load_plain(path):
        config, variables = real_load(path)
        return dataclasses.replace(config, use_pallas=False), variables

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "load_variables", load_plain)
        mp.setenv("TILAWA_PHONEME_RERANK", rerank)
        if oracle:
            mp.setattr(jexp, "_phoneme_checkpoint", lambda: None)
        exp = make()
        raw, rows = {}, []
        predict = exp.predict

        def recording(path):
            rows.clear()
            raw[Path(path).stem] = (predict(path), list(rows))
            return raw[Path(path).stem][0]

        mp.setattr(exp, "predict", recording)
        runtime = getattr(exp, "runtime", None)
        for attr in ("forward_batch", "log_probs_batch"):   # what forward, log_probs call
            if runtime is not None and hasattr(runtime, attr):
                real = getattr(runtime, attr)

                def keep(audios, real=real):
                    out = real(audios)
                    lps, lens = np.asarray(out[0]), np.asarray(out[1])
                    rows.extend((lps[i], int(lens[i])) for i in range(len(audios)))
                    return out

                mp.setattr(runtime, attr, keep)
        samples, corpus_dir = load_manifest("v1")
        if ids:
            samples = [s for s in samples if s["id"] in ids]
        res = run_experiment("ref", exp, samples, corpus_dir)
    files = {s["id"]: Path(s["file"]).stem for s in samples}
    return {r["id"]: decision_row(raw[files[r["id"]]][0], r["predicted"], raw[files[r["id"]]][1])
            for r in res["per_sample"]}


def _jax_phoneme():
    from tilawa_tpu.eval import experiments as jexp

    return jexp.PhonemeExperiment()


def _jax_heldout():
    from tilawa_tpu.eval import experiments as jexp

    return jexp._REGISTRY["heldout"]()


def write_phoneme_ref(path: Path = PHONEME_REF) -> None:
    _write(path, "the JAX package's fastconformer-phoneme through its runner over v1: real "
           "(exports/phoneme-int8, use_pallas=False) and oracle (no bundle), each with "
           "TILAWA_PHONEME_RERANK unset and 1 (*_rerank), CPU",
           {name: jax_decisions(_jax_phoneme, rerank=rerank, oracle=name.startswith("oracle"))
            for name, rerank in PHONEME_SECTIONS.items()})


def write_heldout_ref(path: Path = HELDOUT_REF) -> None:
    _write(path, "the JAX package's heldout experiment (exports/heldout-int4, use_pallas=False, "
           "TTA) through its runner over v1, CPU", {"per_sample": jax_decisions(_jax_heldout)})


SWEEP_CLIPS = ("retasy_000.wav", "retasy_003.wav", "retasy_010.wav", "retasy_016.wav",
               "retasy_017.wav", "retasy_024.wav", "multi_113_001_005.wav", "long_033_056.wav")


def jax_sweep_buckets(clips=SWEEP_CLIPS, keys=None) -> dict[str, dict]:
    """For every context-sweep row of `clips` whose own audio bucket is
    smaller than the clip's: the JAX champion's (use_pallas=False) greedy ids
    at both buckets compared. {"clip@prefix": {"n_own", "n_pad", "t_valid",
    "moved_frames", "max_abs_delta"}}."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from tilawa_tpu.pipeline.runtime import EncoderRuntime, bucket_length
    from tilawa_tpu.train.checkpoint import load_variables
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.context_sweep import sweep_pieces

    cfg, variables = load_variables(ROOT / "exports" / "champion-int4")
    rt = EncoderRuntime(dataclasses.replace(cfg, use_pallas=False), variables)
    out = {}
    for clip in clips:
        names, pieces = sweep_pieces(load_audio(ROOT / "benchmark" / "test_corpus" / clip))
        n_pad = bucket_length(max(len(p) for p in pieces))
        for key, piece in zip(names, pieces):
            row = f"{clip}@{key}"
            if bucket_length(len(piece)) == n_pad or (keys and row not in keys):
                continue
            own, t = rt.log_probs(piece)
            batch = np.zeros((1, n_pad), np.float32)
            batch[0, : len(piece)] = piece
            pad, lens = rt._apply(rt.variables, jnp.asarray(batch),
                                  jnp.asarray([len(piece)], jnp.int32))
            pad = np.asarray(pad)[0, :t]
            assert int(np.asarray(lens)[0]) == t
            out[row] = {"n_own": bucket_length(len(piece)), "n_pad": n_pad, "t_valid": t,
                        "moved_frames": np.flatnonzero(own[:t].argmax(-1) != pad.argmax(-1))
                        .tolist(),
                        "max_abs_delta": float(np.abs(own[:t] - pad).max())}
    return out


def write_sweep_ref(path: Path = SWEEP_REF) -> None:
    _write(path, "the JAX package's champion-int4 (use_pallas=False) on every context-sweep "
           "row of chip_smoke's clips whose own audio bucket is smaller than the clip's: "
           "greedy ids at both buckets, CPU", {"per_row": jax_sweep_buckets()})


@pytest.fixture(scope="module")
def live():
    pytest.importorskip("jax")
    return rows_of(jax_validation(SPOT_IDS))


def decodable_ids() -> list[str]:
    """The v1 clips whose audio is present and decodes here."""
    from tilawa_tpu_torch.data.audio import UnsupportedAudioFormat, load_audio
    from tilawa_tpu_torch.eval.validate_streaming import load_manifest

    samples, corpus_dir = load_manifest("v1")
    decodable = []
    for s in samples:
        path = corpus_dir / s["file"]
        if not path.exists():
            continue
        try:
            load_audio(path)
        except UnsupportedAudioFormat:
            continue
        decodable.append(s["id"])
    return sorted(decodable)


def test_stream_ref_covers_every_decodable_clip():
    assert sorted(load_stream_ref()) == decodable_ids()


def test_stream_tta_ref_covers_every_decodable_clip():
    ref = load_ref(STREAM_TTA_REF)
    assert sorted(ref) == decodable_ids()
    for row in ref.values():
        assert row["tta_cycles"] == len(row["kept"])
    assert json.loads(STREAM_TTA_REF.read_text())["tta_cycles"] == \
        sum(r["tta_cycles"] for r in ref.values())


@pytest.mark.parametrize("clip", SPOT_IDS)
def test_stream_ref_equals_live_jax(live, clip):
    assert live[clip] == load_stream_ref()[clip]


@pytest.fixture(scope="module")
def port_stream6():
    from tilawa_tpu_torch.eval.experiments import load_runtime
    from tilawa_tpu_torch.pipeline.predict import Recognizer

    return Recognizer(load_runtime(STREAM6, device="cpu", long_chunking=False))


@pytest.mark.parametrize("clip", SPOT_IDS)
def test_port_replay_equals_stream_ref(port_stream6, clip):
    from tilawa_tpu_torch.eval.validate_streaming import run_validation

    rec = port_stream6
    ours = rows_of(run_validation(rec.transcribe_result, ids={clip}, db=rec.db,
                                  token_store=rec.token_store, verbose=False))
    assert ours[clip] == load_stream_ref()[clip]


@pytest.fixture(scope="module")
def live_tta():
    pytest.importorskip("jax")
    return rows_of(*jax_tta_validation(SPOT_IDS))


@pytest.mark.parametrize("clip", SPOT_IDS)
def test_stream_tta_ref_equals_live_jax(live_tta, clip):
    assert live_tta[clip] == load_ref(STREAM_TTA_REF)[clip]


# The spot clips whose TTA cycles part from the JAX record, and where: on
# retasy_000 the third TTA cycle forwards an all-zero window (the replay's
# silent tail), whose normalized features differ between the packages
# (ROADMAP C.11): the port decodes [1, 1] where JAX decodes [2, 1], and one
# more cycle follows. The decisions stay equal.
TTA_PARTINGS = {"retasy_000": 2}


@pytest.mark.parametrize("clip", SPOT_IDS)
def test_port_tta_replay_equals_stream_tta_ref(port_stream6, clip):
    """The port's replay with its window TTA on, on the CPU: the JAX
    record's decisions exactly, and its TTA cycles but from the silent
    cycle TTA_PARTINGS names. With the silent windows' features set to the
    JAX package's (jax_silent_features), the whole row equals the record,
    cycles included."""
    from tilawa_tpu_torch.eval.validate_streaming import run_validation
    from tilawa_tpu_torch.pipeline import predict

    def replay():
        return rows_of(*tta_validation(port_stream6, predict, run_validation, {clip}))[clip]

    ours, ref = replay(), load_ref(STREAM_TTA_REF)[clip]
    for key in ("predicted", "final_sequence", "sequence_accuracy"):
        assert ours[key] == ref[key]
    parting = tta_parting(ref, ours)
    assert parting == TTA_PARTINGS.get(clip)
    if parting is not None:
        assert parting in ref["silent"] and parting in ours["silent"]
        with jax_silent_features():
            assert replay() == ref
    else:
        assert ours == ref


def test_phoneme_ref_equals_live_jax():
    pytest.importorskip("jax")
    ref = load_ref(PHONEME_REF, "real")
    assert jax_decisions(_jax_phoneme, SPOT_IDS) == {i: ref[i] for i in SPOT_IDS}


def test_phoneme_oracle_ref_equals_live_jax():
    """The oracle's renders draw from one seeded generator in manifest
    order (the runner's warm-up call first), so the whole corpus is
    re-derived."""
    pytest.importorskip("jax")
    assert jax_decisions(_jax_phoneme, oracle=True) == load_ref(PHONEME_REF, "oracle")


def test_heldout_ref_equals_live_jax():
    pytest.importorskip("jax")
    ref = load_ref(HELDOUT_REF)
    assert jax_decisions(_jax_heldout, SPOT_IDS) == {i: ref[i] for i in SPOT_IDS}


RECORDS = ROOT / "benchmark" / "results"


def _record(name: str) -> dict[str, dict]:
    return {r["id"]: r for r in json.loads((RECORDS / name).read_text())[0]["per_sample"]}


def test_refs_against_the_2026_08_21_records():
    """Where today's JAX package departs from the 2026-08-21 records: the
    streaming record predates the tracker's Viterbi; the phoneme and
    held-out records were taken on a TPU."""
    stream = _record("2026-08-21_204047.json")
    moved = {i for i, r in load_ref(STREAM_REF).items()
             if r["final_sequence"] != _verses(stream[i]["final_sequence"])}
    assert len(moved) == 13 and "retasy_003" in moved
    phoneme = _record("2026-08-21_222020.json")
    assert {i for i, r in load_ref(PHONEME_REF, "real").items()
            if r["predicted"] != _verses(phoneme[i]["predicted"])} == \
        {"ref_059023", "multi_113_001_005", "multi_055_001_004"}
    heldout = _record("2026-08-21_140720.json")
    assert {i for i, r in load_ref(HELDOUT_REF).items()
            if r["predicted"] != _verses(heldout[i]["predicted"])} == {"retasy_015", "ref_059023"}


def test_refs_cover_the_same_clips():
    stream = load_ref(STREAM_REF)
    assert sorted(load_ref(HELDOUT_REF)) == sorted(stream)
    for section in PHONEME_SECTIONS:
        assert sorted(load_ref(PHONEME_REF, section)) == sorted(stream)


def test_sweep_ref_equals_live_jax():
    row = "retasy_003.wav@1"
    ref = load_ref(SWEEP_REF, "per_row")
    assert jax_sweep_buckets(("retasy_003.wav",), {row}) == {row: ref[row]}


def test_sweep_ref_covers_the_chip_smoke_clips():
    import chip_smoke

    assert SWEEP_CLIPS == chip_smoke.CLIPS
    assert len(load_ref(SWEEP_REF, "per_row")) == 27


WRITERS = {"streaming": write_stream_ref, "streaming_tta": write_stream_tta_ref,
           "phoneme": write_phoneme_ref,
           "heldout": write_heldout_ref, "sweep": write_sweep_ref}

if __name__ == "__main__":
    for name in sys.argv[1:] or WRITERS:
        WRITERS[name]()
        print(f"wrote the {name} reference", flush=True)
