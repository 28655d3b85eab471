"""CTC primitives: greedy collapse and batched forward-algorithm scoring.

Port of tilawa_tpu/ops/ctc.py. The JAX scorer is one lax.scan over all
frames; here it is plain PyTorch batched over candidates, with a Python
loop over frames that stops at `t_valid` — the JAX step is the identity
past it, so the result is the same (a hand kernel for the time loop is
queued in ROADMAP.md).

Scores are length-normalized NLL: score[c] = -log p(tokens_c | logprobs) / L_c,
+inf for infeasible candidates (2L+1 > t_valid or L == 0).
"""

from __future__ import annotations

import os

import numpy as np
import torch

NEG_INF = -1e30


def ctc_forward_scores(
    log_probs: torch.Tensor,   # [T, V] float32
    t_valid: int,              # true frame count (<= T)
    tokens: torch.Tensor,      # [C, L] int, zero-padded
    lengths: torch.Tensor,     # [C] int — true token counts
    blank_id: int,
) -> torch.Tensor:
    """Length-normalized CTC NLL of every candidate against one log-prob
    matrix → [C] float32; +inf marks infeasible (2L+1 > t_valid or L == 0).

    alpha is carried split into blank states [C, L+1] and label states
    [C, L], as in the JAX scorer; the label emissions are gathered once for
    the frames the loop reads."""
    t_total = log_probs.shape[0]
    c, l = tokens.shape
    dev = log_probs.device
    tokens = tokens.to(device=dev, dtype=torch.long)
    lengths = lengths.to(device=dev, dtype=torch.long)
    t_run = max(1, min(int(t_valid), t_total))

    lp = log_probs[:t_run]
    lp_lab = lp[:, tokens]                          # [T_run, C, L]
    lp_blk = lp[:, blank_id]                        # [T_run]

    k_idx = torch.arange(l, device=dev)[None, :]
    valid_lab = k_idx < lengths[:, None]                                  # [C, L]
    valid_blk = torch.arange(l + 1, device=dev)[None, :] <= lengths[:, None]  # [C, L+1]
    prev_tok = torch.cat(
        [torch.full((c, 1), -1, dtype=tokens.dtype, device=dev), tokens[:, :-1]], dim=1
    )
    skip = (tokens != prev_tok) & (k_idx > 0)                            # [C, L]

    neg = torch.tensor(NEG_INF, dtype=log_probs.dtype, device=dev)
    neg_col = neg.expand(c, 1)
    a_blk = torch.where(
        (torch.arange(l + 1, device=dev)[None, :] == 0) & valid_blk, lp_blk[0], neg
    )
    a_lab = torch.where((k_idx == 0) & valid_lab, lp_lab[0], neg)

    for t in range(1, t_run):
        lab_shift = torch.cat([neg_col, a_lab], dim=1)                    # [C, L+1]
        new_blk = torch.where(
            valid_blk, torch.logaddexp(a_blk, lab_shift) + lp_blk[t], neg
        )
        lab_prev = torch.cat([neg_col, a_lab[:, :-1]], dim=1)
        total = torch.logaddexp(a_lab, a_blk[:, :l])
        total = torch.logaddexp(total, torch.where(skip, lab_prev, neg))
        a_lab = torch.where(valid_lab, total + lp_lab[t], neg)
        a_blk = new_blk

    final_blank = torch.gather(a_blk, 1, lengths[:, None])[:, 0]
    final_label = torch.gather(a_lab, 1, torch.clamp(lengths - 1, min=0)[:, None])[:, 0]
    final = torch.logaddexp(final_blank, torch.where(lengths > 0, final_label, neg))

    feasible = (2 * lengths + 1 <= int(t_valid)) & (lengths > 0)
    norm = -final / torch.clamp(lengths.to(log_probs.dtype), min=1.0)
    return torch.where(feasible, norm, torch.inf)


def ctc_forward_scores_batch(
    log_probs: torch.Tensor,   # [B, T, V] float32
    t_valid: torch.Tensor,     # [B] true frame counts
    tokens: torch.Tensor,      # [C, L] int, zero-padded
    lengths: torch.Tensor,     # [C] int
    blank_id: int,
) -> torch.Tensor:
    """ctc_forward_scores of every candidate against each of B log-prob
    matrices → [B, C] (the JAX package's vmap over B, one row at a time
    here). Its caller is the sharded dispatch (parallel/dryrun.py
    recognize_scores), which calls it on each data rank's rows."""
    rows = [ctc_forward_scores(lp, tv, tokens, lengths, blank_id)
            for lp, tv in zip(log_probs, t_valid.tolist())]
    if not rows:
        return torch.empty((0, tokens.shape[0]), dtype=log_probs.dtype, device=log_probs.device)
    return torch.stack(rows)


def collapse_ctc(ids, blank_id: int) -> list[int]:
    """CTC collapse: drop repeats then blanks."""
    ids = np.asarray(ids)
    if ids.size == 0:
        return []
    keep = np.ones(len(ids), dtype=bool)
    keep[1:] = ids[1:] != ids[:-1]
    deduped = ids[keep]
    return deduped[deduped != blank_id].tolist()


# Padding helpers ------------------------------------------------------------

def _next_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] if n <= buckets[-1] else int(np.ceil(n / buckets[-1])) * buckets[-1]


def _parse_buckets(raw: str) -> tuple[int, ...]:
    try:
        vals = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError as e:
        raise ValueError(
            f"TILAWA_TOKEN_BUCKETS must be comma-separated ints, got {raw!r}"
        ) from e
    if not vals or vals[0] <= 0:
        raise ValueError(
            f"TILAWA_TOKEN_BUCKETS must be positive ints, got {raw!r}"
        )
    return tuple(vals)


TOKEN_BUCKETS = _parse_buckets(os.getenv("TILAWA_TOKEN_BUCKETS", "128,512"))
CAND_BUCKETS = (512,)
FRAME_BUCKETS = (512, 1024, 2048, 4096)


def pad_candidates(
    token_lists: list[list[int]],
    token_buckets: tuple[int, ...] = TOKEN_BUCKETS,
    cand_buckets: tuple[int, ...] = CAND_BUCKETS,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a ragged candidate token list to bucketed [C_pad, L_pad] int32 +
    lengths [C_pad]."""
    c = len(token_lists)
    lmax = max((len(t) for t in token_lists), default=1)
    l_pad = _next_bucket(max(lmax, 1), token_buckets)
    c_pad = _next_bucket(max(c, 1), cand_buckets)
    tokens = np.zeros((c_pad, l_pad), dtype=np.int32)
    lengths = np.zeros(c_pad, dtype=np.int32)
    for i, ids in enumerate(token_lists):
        tokens[i, : len(ids)] = ids
        lengths[i] = len(ids)
    return tokens, lengths


def pad_frames(
    log_probs: np.ndarray, frame_buckets: tuple[int, ...] = FRAME_BUCKETS
) -> tuple[np.ndarray, int]:
    """Pad [T, V] log-probs to a bucketed frame count; returns (padded, T)."""
    t, v = log_probs.shape
    t_pad = _next_bucket(t, frame_buckets)
    if t_pad == t:
        return log_probs, t
    out = np.full((t_pad, v), 0.0, dtype=log_probs.dtype)
    out[:t] = log_probs
    return out, t
