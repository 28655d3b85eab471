"""Trie-constrained CTC prefix beam search.

Parity with the reference's beam decoder (reference:
web/frontend/src/worker/beam-decode.ts:59-176): every hypothesis is a
prefix of a real verse/span, hypotheses carry split blank/non-blank
log-mass, repeated tokens only extend through the blank path, and beams
are pruned to `beam_width` per frame. Host-side policy — the per-frame
work is O(beam_width * children), tiny next to the device forward.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from tilawa_tpu_torch.text.trie import TokenTrie

NEG_INF = -math.inf


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    hi, lo = (a, b) if a >= b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


@dataclasses.dataclass
class BeamResult:
    token_ids: tuple[int, ...]
    score: float
    matched_refs: list
    is_complete: bool


@dataclasses.dataclass
class _Hyp:
    token_ids: tuple[int, ...]
    blank: float
    non_blank: float
    node: int
    matched: tuple

    @property
    def total(self) -> float:
        return _logaddexp(self.blank, self.non_blank)


def beam_search_decode(
    log_probs: np.ndarray,
    blank_id: int,
    trie: TokenTrie,
    beam_width: int = 8,
    t_valid: int | None = None,
) -> list[BeamResult]:
    """log_probs [T, V] → top hypotheses (best first), each a trie prefix."""
    lp = np.asarray(log_probs, dtype=np.float64)
    if t_valid is not None:
        lp = lp[:t_valid]

    beams: dict[tuple[int, ...], _Hyp] = {
        (): _Hyp((), 0.0, NEG_INF, 0, ())
    }

    for frame in lp:
        blank_lp = float(frame[blank_id])
        nxt: dict[tuple[int, ...], _Hyp] = {}

        for hyp in beams.values():
            prev_total = hyp.total
            if prev_total == NEG_INF:
                continue

            # 1. blank extension: same prefix, same node
            existing = nxt.get(hyp.token_ids)
            if existing is not None:
                existing.blank = _logaddexp(existing.blank, prev_total + blank_lp)
            else:
                nxt[hyp.token_ids] = _Hyp(
                    hyp.token_ids, prev_total + blank_lp, NEG_INF,
                    hyp.node, hyp.matched,
                )

            # 2. every valid trie child
            tokens, kids = trie.children(hyp.node)
            last = hyp.token_ids[-1] if hyp.token_ids else -1
            for tok, child in zip(tokens.tolist(), kids.tolist()):
                tok_lp = float(frame[tok])
                if tok == last:
                    # repeated token: only the blank→non-blank transition
                    new_nb = hyp.blank + tok_lp
                else:
                    new_nb = prev_total + tok_lp
                key = hyp.token_ids + (tok,)
                child_refs = trie.refs_at(child)
                existing = nxt.get(key)
                if existing is not None:
                    existing.non_blank = _logaddexp(existing.non_blank, new_nb)
                    if child_refs and not existing.matched:
                        existing.matched = hyp.matched + tuple(child_refs)
                else:
                    nxt[key] = _Hyp(
                        key, NEG_INF, new_nb, child,
                        hyp.matched + tuple(child_refs) if child_refs
                        else hyp.matched,
                    )

        if len(nxt) > beam_width:
            beams = dict(
                sorted(nxt.items(), key=lambda kv: kv[1].total, reverse=True)
                [:beam_width]
            )
        else:
            beams = nxt

    results = [
        BeamResult(
            token_ids=h.token_ids,
            score=h.total,
            matched_refs=list(h.matched),
            is_complete=trie.is_terminal(h.node),
        )
        for h in beams.values()
    ]
    results.sort(key=lambda r: r.score, reverse=True)
    return results
