"""CTC primitives: greedy collapse and batched forward-algorithm scoring.

Port of tilawa_tpu/ops/ctc.py. The JAX scorer is one lax.scan over all
frames for every candidate at once. Here `ctc_forward_scores` and
`ctc_forward_scores_batch` launch one hand-written CUDA kernel
(csrc/ctc_lattice.cu) for a CUDA tensor, laid out by `lattice_plan` from
(L_pad, C, B, t_valid): one warp a candidate ("warp"), a group of warps on
a named barrier ("group"), or a thread-block cluster whose CTAs hold slices
of the states ("cluster"); padded and infeasible candidates return at once, and
the loop stops at each row's `t_valid`. For a CPU tensor they run the plain
versions, `ctc_forward_scores_plain` (batched over candidates, a Python
loop over frames that stops at `t_valid`: the JAX step is the identity past
it) and `ctc_forward_scores_batch_plain`.

Scores are length-normalized NLL: score[c] = -log p(tokens_c | logprobs) / L_c,
+inf for infeasible candidates (2L+1 > t_valid or L == 0).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from tilawa_tpu_torch.ops import kernels

NEG_INF = -1e30


def ctc_forward_scores_plain(
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


def ctc_forward_scores_batch_plain(
    log_probs: torch.Tensor,   # [B, T, V] float32
    t_valid: torch.Tensor,     # [B] true frame counts
    tokens: torch.Tensor,      # [C, L] int, zero-padded
    lengths: torch.Tensor,     # [C] int
    blank_id: int,
) -> torch.Tensor:
    """ctc_forward_scores_plain of every candidate against each of B
    log-prob matrices → [B, C] (the JAX package's vmap over B, one row at a
    time here)."""
    rows = [ctc_forward_scores_plain(lp, tv, tokens, lengths, blank_id)
            for lp, tv in zip(log_probs, t_valid.tolist())]
    if not rows:
        return torch.empty((0, tokens.shape[0]), dtype=log_probs.dtype, device=log_probs.device)
    return torch.stack(rows)


# The launch plan: how one launch lays candidates on the card. Limits of the
# kernel's layouts (csrc/ctc_lattice.cu) and of the H100: a block's threads
# (a group's launch bound holds the 512 token bucket's 513 state pairs, a
# cluster CTA's 16 warps), its named barriers (one a group: ids 1..15), the
# portable cluster size, and the static shared memory the kernel uses (two
# frames of one boundary label state a warp; a cluster's CTA adds two
# exchanges of its halo's 32 label and blank states). One state pair (a
# blank and a label state) a thread.
GROUP_THREADS = 544
CLUSTER_THREADS = 512
MAX_SLOTS = 15
PORTABLE_CLUSTER = 8       # CTAs a cluster may hold on any Hopper card
MAX_CLUSTER = 16           # the H100's limit, past the portable one
LATTICE_SMEM = 2 * 32 * 4
HALO_SMEM = 2 * 2 * 32 * 4
_MAX_GRID_Y = 65535
_MAX_GRID_X = 2**31 - 1
_WARP_SLOTS = 4            # one-warp candidates a block


@dataclass(frozen=True)
class LatticePlan:
    """One launch's layout: `warps` warps a candidate's group (a CTA's, for
    "cluster"), `slots` groups a block, `cluster` CTAs a candidate, and the
    grid."""
    variant: str           # "warp", "group" or "cluster"
    warps: int
    slots: int
    cluster: int
    grid: tuple[int, int]

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.slots

    @property
    def smem(self) -> int:
        return LATTICE_SMEM + (HALO_SMEM if self.cluster > 1 else 0)

    def describe(self) -> str:
        where = (f"{self.cluster} CTAs of {self.warps} warps, a halo's included"
                 if self.cluster > 1
                 else f"{self.slots} x {self.warps} warp(s) a block")
        return f"{self.variant} ({where}, grid {self.grid})"


def _warps_for(states: int) -> int:
    return -(-states // 32)


def longest_feasible(l_pad: int, t_valid: int | None) -> int:
    """The longest candidate a launch can have to score: L_pad, or where one
    t_valid holds for every row, (t_valid - 1) // 2 if less (a longer one
    is infeasible: 2 L + 1 > t_valid). csrc/ctc_lattice.cu's own rule."""
    if t_valid is None:
        return l_pad
    return max(0, min(l_pad, (int(t_valid) - 1) // 2))


def lattice_plan(l_pad: int, c: int, b: int, variant: str | None = None,
                 t_valid: int | None = None) -> LatticePlan:
    """The lattice kernel's layout for a launch of C candidates of L_pad
    tokens against B log-prob rows, a pure function of its arguments; the
    layout holds the longest candidate that can be feasible
    (longest_feasible: t_valid, where one holds for every row, bounds it).
    By default: "warp" where its states fit one warp, "group" (a group of
    warps a candidate) where they fit one block, else a "cluster" of 8 CTAs
    a candidate, or 16 where 8 cannot hold it. `variant` asks for one of
    them. Raises ValueError where the variant cannot hold the states or the
    grid does not fit the card."""
    if l_pad < 1:
        raise ValueError(f"lattice: L_pad {l_pad} must be positive")
    if not 1 <= b <= _MAX_GRID_Y:
        raise ValueError(f"lattice: B = {b} rows do not fit one launch")
    states = longest_feasible(l_pad, t_valid) + 1
    c = max(c, 1)
    if variant is None:
        variant = ("warp" if states <= 32 else
                   "group" if 32 * _warps_for(states) <= GROUP_THREADS else "cluster")
    if variant == "warp":
        if states > 32:
            raise ValueError(f"lattice: L_pad {l_pad} does not fit one warp")
        slots = min(_WARP_SLOTS, c)
        plan = LatticePlan("warp", 1, slots, 1, (-(-c // slots), b))
    elif variant == "group":
        warps = _warps_for(states)
        if 32 * warps > GROUP_THREADS:
            raise ValueError(f"lattice: L_pad {l_pad} does not fit one block")
        slots = max(1, min(GROUP_THREADS // (32 * warps), MAX_SLOTS, c))
        plan = LatticePlan("group", warps, slots, 1, (-(-c // slots), b))
    elif variant == "cluster":
        n = PORTABLE_CLUSTER
        if 32 * (1 + _warps_for(-(-states // n))) > CLUSTER_THREADS:
            n = MAX_CLUSTER
        warps = 1 + _warps_for(-(-states // n))    # the halo warp first
        if 32 * warps > CLUSTER_THREADS:
            raise ValueError(f"lattice: L_pad {l_pad} does not fit {n} CTAs")
        plan = LatticePlan("cluster", warps, 1, n, (c * n, b))
    else:
        raise ValueError(f"lattice: no variant {variant!r}")
    if plan.grid[0] > _MAX_GRID_X:
        raise ValueError(f"lattice: {plan} does not fit the card")
    return plan


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _launch(what: str, log_probs: torch.Tensor, t_valid, tokens: torch.Tensor,
            lengths: torch.Tensor, blank_id: int, plan: LatticePlan | None = None
            ) -> torch.Tensor:
    """One launch of the lattice kernel for log_probs [B, T, V] on a CUDA
    device against every candidate → scores [B, C], laid out by `plan`
    (lattice_plan's by default; it raises for a shape no variant fits).
    t_valid is a host int (one for every row) or a [B] tensor on the card,
    read there: no host sync either way."""
    if tokens.dim() != 2 or lengths.shape != (tokens.shape[0],):
        raise ValueError(f"{what}: tokens must be [C, L] and lengths [C]")
    (b, t_total, vocab), (c, l_pad) = log_probs.shape, tokens.shape
    rows_given = isinstance(t_valid, torch.Tensor)
    plan = plan or lattice_plan(l_pad, c, max(b, 1),
                                t_valid=None if rows_given else int(t_valid))
    if log_probs.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {log_probs.device}")
    if log_probs.dtype != torch.float32 or t_total == 0:
        raise ValueError(f"{what}: log_probs must be float32 with at least one frame")
    if tokens.device != log_probs.device or lengths.device != log_probs.device:
        raise ValueError(f"{what}: tokens and lengths must be on {log_probs.device}")
    if not 0 <= blank_id < log_probs.shape[-1]:
        raise ValueError(f"{what}: blank {blank_id} outside the vocabulary")
    scores = torch.empty((b, c), dtype=torch.float32, device=log_probs.device)
    if not (b and c):
        return scores
    rows, t_scalar = None, 0
    if rows_given:
        if t_valid.shape != (b,) or t_valid.device != log_probs.device:
            raise ValueError(f"{what}: t_valid must be [B] on the log-probs' device")
        rows = t_valid.to(torch.int32).contiguous()
    else:
        t_scalar = int(t_valid)
    if log_probs.stride(-1) != 1:
        log_probs = log_probs.contiguous()
    tokens = tokens.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    fn = kernels.function("ctc_lattice", "tilawa_ctc_lattice", _ARGTYPES)
    err = fn(
        log_probs.data_ptr(), log_probs.stride(0), log_probs.stride(1), b, t_total, vocab,
        rows.data_ptr() if rows is not None else None, t_scalar, tokens.data_ptr(),
        lengths.data_ptr(), c, l_pad, blank_id, scores.data_ptr(), plan.warps, plan.slots,
        plan.cluster, plan.grid[0], torch.cuda.current_stream(log_probs.device).cuda_stream,
    )
    kernels.check(err, what)
    kernels.LAUNCHES["ctc_lattice"] += 1
    return scores


def ctc_forward_scores(
    log_probs: torch.Tensor,   # [T, V] float32
    t_valid: int,              # true frame count (<= T)
    tokens: torch.Tensor,      # [C, L] int, zero-padded
    lengths: torch.Tensor,     # [C] int — true token counts
    blank_id: int,
) -> torch.Tensor:
    """Length-normalized CTC NLL of every candidate against one log-prob
    matrix → [C] float32; +inf marks infeasible (2L+1 > t_valid or L == 0).
    One launch of the lattice kernel for a CUDA tensor (tokens and lengths
    on the same card, t_valid a host int: no host sync);
    ctc_forward_scores_plain for a CPU tensor."""
    kernels.forward_only("ctc_forward_scores", log_probs)
    if log_probs.device.type == "cpu":
        return ctc_forward_scores_plain(log_probs, t_valid, tokens, lengths, blank_id)
    if log_probs.dim() != 2:
        raise ValueError("ctc_forward_scores: log_probs must be [T, V]")
    return _launch("ctc_forward_scores", log_probs[None], t_valid, tokens, lengths,
                   blank_id)[0]


def ctc_forward_scores_batch(
    log_probs: torch.Tensor,   # [B, T, V] float32
    t_valid: torch.Tensor,     # [B] true frame counts
    tokens: torch.Tensor,      # [C, L] int, zero-padded
    lengths: torch.Tensor,     # [C] int
    blank_id: int,
) -> torch.Tensor:
    """ctc_forward_scores of every candidate against each of B log-prob
    matrices → [B, C] (the JAX package's vmap over B). For a CUDA tensor
    one launch for all B rows, each row's t_valid read on the card;
    ctc_forward_scores_batch_plain for a CPU tensor. Its caller is the
    sharded dispatch (parallel/dryrun.py recognize_scores), which calls it
    on each data rank's rows."""
    kernels.forward_only("ctc_forward_scores_batch", log_probs)
    if log_probs.device.type == "cpu":
        return ctc_forward_scores_batch_plain(log_probs, t_valid, tokens, lengths, blank_id)
    if log_probs.dim() != 3 or not isinstance(t_valid, torch.Tensor):
        raise ValueError("ctc_forward_scores_batch: log_probs must be [B, T, V] and t_valid "
                         "a [B] tensor")
    return _launch("ctc_forward_scores_batch", log_probs, t_valid, tokens, lengths, blank_id)


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
