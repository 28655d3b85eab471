"""CTC forced-alignment rerank of retrieval candidates on the device.

Port of tilawa_tpu/pipeline/rerank.py (reference: experiments/c2c-direct/
run.py:314-380: feasibility 2L+1 <= T, length normalization, SPAN_PENALTY
per extra verse, final_score = -norm_loss + TEXT_WEIGHT*text_score -
penalty). Device-resident log-probs from the runtime stay a torch tensor on
their device throughout; host numpy log-probs are padded and scored on
the CPU.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from tilawa_tpu_torch.data.assets import BLANK_ID
from tilawa_tpu_torch.data.token_store import TokenStore
from tilawa_tpu_torch.device import upload
from tilawa_tpu_torch.ops.ctc import (
    CAND_BUCKETS,
    TOKEN_BUCKETS,
    _next_bucket,
    ctc_forward_scores,
    ctc_forward_scores_plain,
    pad_candidates,
    pad_frames,
)

SPAN_PENALTY = float(os.getenv("TILAWA_SPAN_PENALTY", "0.5"))
TEXT_WEIGHT = float(os.getenv("TILAWA_TEXT_WEIGHT", "0.0"))


def span_len(c: dict) -> int:
    return (c.get("ayah_end") or c["ayah"]) - c["ayah"] + 1


# Bound on the [T, C, L] float32 emission-gather buffer of one scorer call,
# as in the JAX package. Only the plain scorer builds that buffer, so the cap
# holds only where it runs; the CUDA kernel reads emissions from log_probs,
# and there a chunk is a whole L bucket of up to 512 candidates, padded to
# the next of KERNEL_CAND_BUCKETS over its own count (the kernel compiles
# nothing per shape, and a smaller block uploads less).
_MAX_GATHER_BYTES = int(os.getenv("TILAWA_RERANK_GATHER_BYTES", str(768 << 20)))
KERNEL_CAND_BUCKETS = (64, 128, 256, 512)


def _cand_bucket_for(t_frames: int, l_pad: int) -> int:
    """Candidate-axis padding for a given (T, L): the largest power-of-two
    in [64, 512] keeping the [T, C, L] emission gather under the byte
    bound."""
    c = 512
    while c > 64 and t_frames * c * l_pad * 4 > _MAX_GATHER_BYTES:
        c //= 2
    return c


def _chunks(t_frames: int, lengths: list[int], capped: bool) -> list[tuple[int, int, int, int]]:
    """The scorer chunks of candidates of these token lengths (ascending):
    (start, end, L_pad, C_pad) each, one L bucket a chunk. `capped` (the
    plain scorer) bounds C_pad by _cand_bucket_for, as the JAX package
    does; else a chunk holds up to CAND_BUCKETS' 512 candidates and C_pad
    is the KERNEL_CAND_BUCKETS bucket of its count."""
    out, pos = [], 0
    while pos < len(lengths):
        l_pad = _next_bucket(max(lengths[pos], 1), TOKEN_BUCKETS)
        cap = _cand_bucket_for(t_frames, l_pad) if capped else CAND_BUCKETS[-1]
        end = pos
        while end < len(lengths) and end - pos < cap and lengths[end] <= l_pad:
            end += 1
        c_pad = cap if capped else _next_bucket(end - pos, KERNEL_CAND_BUCKETS)
        out.append((pos, end, l_pad, c_pad))
        pos = end
    return out


def _score_feasible(
    lp_dev: torch.Tensor, t: int, token_lists: list[list[int]],
    order: list[int], blank_id: int, plain: bool,
) -> np.ndarray:
    """Score candidates (already sorted by token length) in L-bucketed
    chunks, bounded by the gather cap where the plain scorer runs (`plain`,
    or a CPU tensor, which ctc_forward_scores scores plainly); returns
    scores aligned with `order`."""
    scorer = ctc_forward_scores_plain if plain else ctc_forward_scores
    capped = plain or lp_dev.device.type == "cpu"
    out = np.full(len(order), np.inf, dtype=np.float64)
    lengths = [len(token_lists[i]) for i in order]
    for pos, end, l_pad, c_pad in _chunks(lp_dev.shape[0], lengths, capped):
        chunk = order[pos:end]
        tokens, lengths_pad = pad_candidates(
            [token_lists[i] for i in chunk],
            token_buckets=(l_pad,),
            cand_buckets=(c_pad,),
        )
        scores = scorer(
            lp_dev, t, upload(tokens, lp_dev.device), upload(lengths_pad, lp_dev.device),
            blank_id,
        ).cpu().numpy()
        out[pos:end] = scores[: len(chunk)]
    return out


def score_token_lists(
    log_probs: np.ndarray | torch.Tensor,
    t_valid: int,
    token_lists: list[list[int]],
    blank_id: int = BLANK_ID,
    *,
    plain: bool = False,
) -> np.ndarray:
    """Length-normalized CTC forced-alignment NLL per token list; +inf for
    empty/infeasible (2L+1 > T) entries. A torch tensor is scored where it
    lies (the runtime's frame-bucket padded log-probs); a numpy array is
    padded to a frame bucket and scored on the CPU. `plain` scores with the
    plain lattice on any device (the card's reference for the kernel)."""
    out = np.full(len(token_lists), np.inf, dtype=np.float64)
    feasible = [
        i for i, ids in enumerate(token_lists)
        if ids and 2 * len(ids) + 1 <= t_valid
    ]
    feasible.sort(key=lambda i: len(token_lists[i]))
    if feasible:
        if isinstance(log_probs, torch.Tensor):
            lp_dev, t = log_probs, t_valid
        else:
            lp_padded, t = pad_frames(
                np.asarray(log_probs[:t_valid], dtype=np.float32)
            )
            lp_dev = torch.from_numpy(lp_padded)
        scores = _score_feasible(lp_dev, t, token_lists, feasible, blank_id, plain)
        for j, i in enumerate(feasible):
            out[i] = scores[j]
    return out


def choose_longest_stable_prefix(
    log_probs: np.ndarray | torch.Tensor,
    t_valid: int,
    prefixes: list[list[int]],
    tolerance: float = 0.12,
    blank_id: int = BLANK_ID,
) -> int | None:
    """Index of the LONGEST prefix whose normalized CTC score stays within
    `tolerance` of the best feasible score (reference:
    lib/ctc-rescore.ts:128-147 — used by tracking word progress: prefer the
    deepest prefix the acoustics still support)."""
    if not prefixes:
        return None
    scores = score_token_lists(log_probs, t_valid, prefixes, blank_id)
    order = sorted(
        (i for i in range(len(prefixes)) if math.isfinite(scores[i])),
        key=lambda i: scores[i],
    )
    if not order:
        return None
    best_score = scores[order[0]]
    best = order[0]
    for i in order:
        if scores[i] > best_score + tolerance:
            break
        if len(prefixes[i]) >= len(prefixes[best]):
            best = i
    return best


def ctc_rerank(
    log_probs: np.ndarray | torch.Tensor,
    t_valid: int,
    candidates: list[dict],
    token_store: TokenStore,
    blank_id: int = BLANK_ID,
    span_penalty: float = SPAN_PENALTY,
    text_weight: float = TEXT_WEIGHT,
) -> list[dict]:
    """Annotate candidates with ctc_norm_loss/final_score; return the
    feasible ones sorted best-first. Infeasible candidates are dropped
    host-side before any padding."""
    if not candidates:
        return []

    token_lists = [token_store.ids_for_candidate(c) for c in candidates]
    scores = score_token_lists(log_probs, t_valid, token_lists, blank_id)

    for i, cand in enumerate(candidates):
        norm_loss = float(scores[i])
        cand["ctc_len"] = len(token_lists[i])
        if math.isfinite(norm_loss):
            cand["ctc_norm_loss"] = norm_loss
            cand["ctc_loss"] = norm_loss * max(len(token_lists[i]), 1)
            text_score = float(cand.get("score") or 0.0)
            penalty = span_penalty * (span_len(cand) - 1)
            cand["final_score"] = -norm_loss + text_weight * text_score - penalty
        else:
            cand["ctc_norm_loss"] = float("inf")
            cand["ctc_loss"] = float("inf")
            cand["final_score"] = -float("inf")

    ranked = [c for c in candidates if math.isfinite(c["ctc_norm_loss"])]
    ranked.sort(key=lambda c: c["final_score"], reverse=True)
    return ranked
