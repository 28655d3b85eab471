"""Word n-gram language model + shallow-fusion rescoring.

The reference's LM-fusion experiment shallow-fuses a KenLM 5-gram char LM
(alpha 0.7, beta 1.0) and a custom Quran-constrained word LM into CTC beam
decoding (reference: experiments/fastconformer-quran-lm-fusion/run.py:41-69;
assets built by scripts/build_quran_kenlm.py → quran_corpus.txt +
quran_unigrams.txt). KenLM is a C++ dependency the survey marks optional
(SURVEY.md §2.8); the framework equivalent is this self-contained n-gram
model over the same corpus assets — stupid-backoff scoring (Brants et al.
2007), which tracks Kneser-Ney closely at Quran-corpus scale without the
C++ toolchain — plus n-best rescoring hooks.
"""

from __future__ import annotations

import math
from collections import defaultdict
from pathlib import Path

from tilawa_tpu_torch.data.assets import default_asset_path

BOS = "<s>"
EOS = "</s>"


class NGramLM:
    """Count-based word n-gram LM with stupid backoff.

    score(w | context) = log f(context+w)/f(context) if seen, else
    log(0.4) + score(w | shorter context); unigram floor is an OOV
    penalty. Deterministic, no smoothing hyperparameters to tune.
    """

    def __init__(self, order: int = 5, backoff: float = 0.4):
        self.order = order
        self.backoff = backoff
        self.counts: list[dict[tuple, int]] = [
            defaultdict(int) for _ in range(order)
        ]
        self.total_words = 0
        self.vocab: set[str] = set()

    # ---------------------------------------------------------------- train

    def add_sentence(self, words: list[str]) -> None:
        toks = [BOS] * (self.order - 1) + list(words) + [EOS]
        self.total_words += len(words) + 1
        self.vocab.update(words)
        for i in range(self.order - 1, len(toks)):
            for n in range(1, self.order + 1):
                if i - n + 1 < 0:
                    break
                self.counts[n - 1][tuple(toks[i - n + 1: i + 1])] += 1

    @classmethod
    def train(cls, lines: list[str], order: int = 5) -> "NGramLM":
        lm = cls(order=order)
        for line in lines:
            words = line.split()
            if words:
                lm.add_sentence(words)
        return lm

    @classmethod
    def from_corpus_file(
        cls, path: str | Path | None = None, order: int = 5
    ) -> "NGramLM":
        p = Path(path) if path else default_asset_path("kenlm/quran_corpus.txt")
        lines = [
            ln.strip().lstrip("﻿")
            for ln in p.read_text(encoding="utf-8").splitlines()
        ]
        return cls.train([ln for ln in lines if ln], order=order)

    # ---------------------------------------------------------------- score

    def logp(self, word: str, context: tuple[str, ...] = ()) -> float:
        """Stupid-backoff log10 score of `word` given up to order-1 context
        words (most recent last)."""
        ctx = tuple(context)[-(self.order - 1):]
        penalty = 0.0
        for n in range(len(ctx) + 1, 0, -1):
            gram = ctx[len(ctx) - n + 1:] + (word,)
            num = self.counts[n - 1].get(gram)
            if num:
                if n == 1:
                    return penalty + math.log10(num / self.total_words)
                den = self.counts[n - 2].get(gram[:-1])
                if den:
                    return penalty + math.log10(num / den)
            penalty += math.log10(self.backoff)
        # OOV floor
        return penalty + math.log10(1.0 / (self.total_words + len(self.vocab) + 1))

    def sentence_logp(self, words: list[str], include_eos: bool = True) -> float:
        ctx: tuple[str, ...] = (BOS,) * (self.order - 1)
        total = 0.0
        for w in words:
            total += self.logp(w, ctx)
            ctx = (ctx + (w,))[-(self.order - 1):]
        if include_eos:
            total += self.logp(EOS, ctx)
        return total

    def perplexity(self, words: list[str]) -> float:
        if not words:
            return float("inf")
        lp = self.sentence_logp(words)
        return 10 ** (-lp / (len(words) + 1))


def load_unigrams(path: str | Path | None = None) -> list[str]:
    """The pyctcdecode-style unigram word list asset."""
    p = Path(path) if path else default_asset_path("kenlm/quran_unigrams.txt")
    return [
        w.strip().lstrip("﻿")
        for w in p.read_text(encoding="utf-8").splitlines()
        if w.strip()
    ]


def lm_rescore(
    hypotheses: list[dict],
    lm: NGramLM,
    alpha: float = 0.7,
    beta: float = 1.0,
    text_key: str = "text",
    score_key: str = "score",
) -> list[dict]:
    """Shallow fusion over an n-best list: fused = acoustic +
    alpha * lm_logp + beta * n_words (the reference's alpha/beta roles,
    lm-fusion run.py:41-69). Returns a new list sorted best-first with
    `lm_logp` and `fused_score` attached."""
    out = []
    for h in hypotheses:
        words = str(h.get(text_key, "")).split()
        lm_lp = lm.sentence_logp(words) if words else -math.inf
        fused = float(h.get(score_key, 0.0)) + alpha * lm_lp + beta * len(words)
        out.append({**h, "lm_logp": lm_lp, "fused_score": fused})
    out.sort(key=lambda h: h["fused_score"], reverse=True)
    return out


def build_lm_assets(quran_path: str | Path | None = None,
                    out_dir: str | Path | None = None) -> tuple[Path, Path]:
    """Regenerate quran_corpus.txt + quran_unigrams.txt from quran.json
    (parity with scripts/build_quran_kenlm.py write_corpus_and_unigrams)."""
    import json

    qp = Path(quran_path) if quran_path else default_asset_path("quran.json")
    od = Path(out_dir) if out_dir else (qp.parent / "kenlm")
    od.mkdir(parents=True, exist_ok=True)
    verses = json.loads(qp.read_text(encoding="utf-8"))
    lines = [
        " ".join(v.get("text_clean", "").split())
        for v in verses
        if v.get("text_clean", "").strip()
    ]
    corpus = od / "quran_corpus.txt"
    corpus.write_text("\n".join(lines) + "\n", encoding="utf-8")
    unigrams = od / "quran_unigrams.txt"
    vocab = sorted({w for ln in lines for w in ln.split()})
    unigrams.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return corpus, unigrams
