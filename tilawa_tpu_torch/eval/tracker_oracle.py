"""Tracker policy ceiling: drive RecitationTracker with oracle transcripts.

The streaming score is the product of two factors the real run can't
separate: (a) how well the model decodes partial rolling windows, and
(b) how well the tracker policy (discovery/tracking FSM, commit rules,
windowing) turns decodes into verse emissions. This diagnostic removes
(a): for every window the tracker asks about, a fake transcriber returns
the *ideal* decode — the forced-alignment tokens (assets/alignments_*.npz,
tilawa_tpu/train/align.py) that fall inside that window — plus synthetic
CTC log-probs paced like real FastConformer output, so the tracker's
acoustic fusion and CTC rescue paths stay live.

The resulting score is the tracker's policy ceiling on this corpus: the
gap between it and 100% is pure policy loss; the gap between the real
streaming run and it is model-robustness loss (the stream2/stream3
finetune campaign, EXPERIMENTS.md). This is the role the reference's
mocked-transcribe suites play (reference:
web/frontend/test/tracker-deferred.test.ts:1-17 fake backend;
shared tests tests/test_streaming_pipeline.py:36-60 mock transcribe),
lifted from hand-written fixtures to whole-corpus replay.

Window→token mapping: the tracker's rolling window always ends at the
newest fed sample, so `replay_sample`'s `on_chunk(fed)` callback pins the
absolute end time; the start is `end - len(window)`. `--cut-mode drop`
(default) models ideal ASR that omits tokens cut by the window edge;
`--cut-mode garble` substitutes a random token for edge-cut ones,
simulating what a real acoustic model does to half-heard words.

Port of tilawa_tpu/eval/tracker_oracle.py: no model and no device runs,
so it needs neither the card nor a --device flag (the tracker's CTC
fusion scores the rendered log-probs on the host).

Usage:
  python -m tilawa_tpu_torch.eval.tracker_oracle --corpus v1
  ... --noise 0.3 --cut-mode garble   # harsher, more realistic
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from tilawa_tpu_torch.data.assets import ASSETS_DIR, BLANK_ID, VOCAB_TOKENS
from tilawa_tpu_torch.data.normalizer import normalize_arabic
from tilawa_tpu_torch.data.quran import QuranDB
from tilawa_tpu_torch.data.token_store import TokenStore
from tilawa_tpu_torch.data.tokenizer import SentencePieceBPE
from tilawa_tpu_torch.eval.validate_streaming import run_validation
from tilawa_tpu_torch.pipeline.runtime import OracleRuntime
from tilawa_tpu_torch.streaming.config import STREAMING_PRESETS
from tilawa_tpu_torch.streaming.tracker import TranscribeResult


def load_alignments(corpus: str) -> dict[str, dict[str, np.ndarray]]:
    path = ASSETS_DIR / f"alignments_{corpus}.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"{path} missing — run tilawa_tpu_torch.train.align for corpus {corpus}"
        )
    raw = np.load(path, allow_pickle=True)
    out: dict[str, dict[str, np.ndarray]] = {}
    for key in raw.files:
        sid, field = key.rsplit("::", 1)
        out.setdefault(sid, {})[field] = raw[key]
    return out


class OracleWindowTranscriber:
    """Per-sample fake acoustic backend for RecitationTracker."""

    def __init__(
        self,
        token_ids: np.ndarray,
        starts: np.ndarray,
        ends: np.ndarray,
        tokenizer: SentencePieceBPE,
        renderer: OracleRuntime,
        cut_mode: str = "drop",
        rng: np.random.Generator | None = None,
    ):
        self.token_ids = np.asarray(token_ids, np.int32)
        self.starts = np.asarray(starts, np.int64)
        self.ends = np.asarray(ends, np.int64)
        self.tokenizer = tokenizer
        self.renderer = renderer
        self.cut_mode = cut_mode
        self.rng = rng or np.random.default_rng(0)
        self.fed = 0  # absolute end (samples) of the newest fed chunk

    def on_chunk(self, fed_samples: int) -> None:
        self.fed = fed_samples

    def _window_ids(self, n_window: int) -> list[int]:
        t1 = self.fed
        t0 = max(0, t1 - n_window)
        inside = (self.starts >= t0) & (self.ends <= t1)
        ids = list(self.token_ids[inside])
        if self.cut_mode == "garble":
            # Tokens the window edge cuts through become random ids —
            # the oracle analogue of half-heard words.
            cut = ((self.starts < t0) & (self.ends > t0)) | (
                (self.starts < t1) & (self.ends > t1)
            )
            for flag, s in zip(cut, self.starts):
                if not flag:
                    continue
                tok = int(self.rng.integers(0, VOCAB_TOKENS - 1))
                if s < t0:
                    ids.insert(0, tok)
                else:
                    ids.append(tok)
        return [int(i) for i in ids]

    def __call__(self, window: np.ndarray) -> TranscribeResult:
        ids = self._window_ids(len(window))
        text = (
            normalize_arabic(self.tokenizer.decode(ids).strip()) if ids else ""
        )
        lp, t_valid = self.renderer.render_ids(ids)
        return TranscribeResult(
            text=text, token_ids=ids, log_probs=lp, t_valid=t_valid
        )


def make_factory(
    corpus: str,
    tokenizer: SentencePieceBPE,
    noise: float = 0.15,
    error_rate: float = 0.0,
    cut_mode: str = "drop",
    seed: int = 0,
):
    alignments = load_alignments(corpus)
    degenerate: list[str] = []

    def alignment_degenerate(align, audio: np.ndarray) -> bool:
        """Broken forced alignments produce near-empty oracle windows —
        scoring them measures the aligner's failure, not tracker policy.
        Degenerate = tokens collapsed to clip edges (huge internal gap),
        near-zero token coverage of the clip, or a single token for a
        multi-second clip (audited examples: ea_alafasy_030001 holds ONE
        token; ea_husary_026100/026122 gap 9-10 s)."""
        starts = np.asarray(align["starts"], dtype=np.int64)
        ends = np.asarray(align["ends"], dtype=np.int64)
        clip_s = len(audio) / 16000.0
        if len(starts) <= 1:
            return clip_s > 2.0
        max_gap_s = float((starts[1:] - ends[:-1]).max()) / 16000.0
        # Long internal gaps are COMMON in these alignments (v3 median
        # max-gap 4.2 s — un-labelled bismillah audio and slow-recitation
        # pauses), so only the unambiguous tail is excluded: >10 s is the
        # ~97th percentile and matches the audited empty-emission
        # failures (ea_husary_026100/026122).
        return max_gap_s > 10.0

    def factory(sample: dict, audio: np.ndarray):
        align = alignments.get(sample["id"])
        if align is None:
            return None  # skip samples without a forced alignment
        if alignment_degenerate(align, audio):
            degenerate.append(sample["id"])
            return None
        # Per-sample seeding: one shared RNG would couple every sample's
        # noise to how many transcribe calls earlier samples made, so any
        # policy change scrambles all downstream samples and per-sample
        # regressions can't be attributed.
        import zlib

        sample_seed = (zlib.crc32(sample["id"].encode()) ^ seed) & 0x7FFFFFFF
        renderer = OracleRuntime(
            lambda *a: [], blank_id=BLANK_ID, vocab_size=VOCAB_TOKENS,
            noise=noise, error_rate=error_rate, seed=sample_seed,
        )
        return OracleWindowTranscriber(
            align["token_ids"], align["starts"], align["ends"],
            tokenizer, renderer, cut_mode=cut_mode,
            rng=np.random.default_rng(sample_seed),
        )

    factory.degenerate = degenerate
    return factory


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="tracker oracle ceiling")
    parser.add_argument("--corpus", default="v1")
    parser.add_argument("--category", default=None)
    parser.add_argument("--chunk", type=float, default=0.3)
    parser.add_argument("--preset", default=None,
                        choices=[None, *STREAMING_PRESETS])
    parser.add_argument("--noise", type=float, default=0.15)
    parser.add_argument("--error-rate", type=float, default=0.0)
    parser.add_argument("--cut-mode", default="drop",
                        choices=["drop", "garble"])
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--ids", default=None,
                        help="comma-separated sample ids to replay")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--out", default=None,
                        help="write full per-sample JSON here")
    args = parser.parse_args(argv)

    tokenizer = SentencePieceBPE.load_default()
    factory = make_factory(
        args.corpus, tokenizer, noise=args.noise,
        error_rate=args.error_rate, cut_mode=args.cut_mode, seed=args.seed,
    )
    result = run_validation(
        None,
        corpus=args.corpus,
        category=args.category,
        chunk_seconds=args.chunk,
        preset=args.preset,
        limit=args.limit,
        ids=set(args.ids.split(",")) if args.ids else None,
        db=QuranDB(),
        token_store=TokenStore.load_default(),
        verbose=args.verbose,
        transcribe_factory=factory,
        name=f"tracker-oracle-{args.cut_mode}",
    )
    summary = {
        k: (round(v, 4) if isinstance(v, float) else v)
        for k, v in result.items() if k != "per_sample"
    }
    # Itemize excluded degenerate-alignment inputs so the ceiling number
    # is auditable (they count in `skipped`, never as passes).
    summary["alignment_degenerate"] = sorted(factory.degenerate)
    print(json.dumps(summary, ensure_ascii=False))
    if args.out:
        Path(args.out).write_text(json.dumps(result, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
