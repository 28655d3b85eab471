"""CTC primitives: greedy collapse, batched forward-algorithm scoring and
the training loss.

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

`ctc_loss` is the training loss, optax.ctc_loss per row with its input
gradient (the JAX package trains through jax.value_and_grad of it: an XLA
scan, no Pallas kernel). It is an autograd Function (CTCLoss): for a CUDA
tensor its forward and its backward each launch the hand-written kernels of
csrc/ctc_loss.cu once, each row's chains laid out by `loss_plan` from
(N, B): one warp a row ("warp"), a group of warps on a named barrier
("group") or a thread-block cluster whose CTAs hold slices of the row
("cluster"); for a CPU tensor they run the plain versions, `ctc_loss_plain`
(optax's recursion, a Python loop over frames) and `ctc_loss_grad_plain`
(the same recursion's adjoints, back over the frames).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tilawa_tpu_torch.ops import kernels

NEG_INF = -1e30
LOG_EPSILON = -1e5   # optax.ctc_loss's log(0)


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


# The training loss -------------------------------------------------------------
#
# Per row b: x[b] [T, V] f32, enc_len[b] frames (frames at or past it keep the
# state), labels tokens[b, :L_b] (right-padded to N), blank. lp =
# log_softmax(x) (optax normalizes its input again); blank states phi [N + 1]
# and label states emit [N], log(0) = log_epsilon, start phi[0] = 0; a frame:
#
#   pp[0] = phi[0];  pp[k] = lae(phi[k], emit[k-1] + c1[k-1])      (k >= 1)
#   emit'[k] = lae(pp[k] + lp[tok[k]], emit[k] + lp[tok[k]])
#   phi'[0] = pp[0] + lp[blank]
#   phi'[k] = lae(pp[k] + lp[blank], (emit[k-1] + lp[blank]) + c2[k-1])
#
# with repeat[k] = tokens[k] == tokens[k + 1] over the padded row (0 at the
# last column), c1 = log_epsilon * repeat and c2 = log_epsilon * (1 - repeat),
# lae = logaddexp; loss = -lae(phi[L], emit[L-1]), or -phi[0] at L = 0. The
# states past L never reach phi[L]. The gradient is reverse-mode through the
# same recursion, as jax.value_and_grad takes it: every lae(a, b) = out hands
# its output's adjoint to a and b weighted exp(a - out) and exp(b - out). The
# adjoint of lp[t, v], gamma[t, v], is the occupation posterior of the paths
# that emit v at t; the gradient at x is g * (softmax(x) * sum_v gamma - gamma),
# 0 at padded frames. Adjoints are probabilities (<= 1): the frames' huge
# log_epsilon terms of an infeasible row cancel inside each weight's a - out,
# one lae at a time, as in autodiff.

# Limits of csrc/ctc_loss.cu's layouts: one state pair (phi[k], emit[k]) a
# thread; a block of at most 512 threads (a group's, or a cluster CTA's with
# its halo warp of 32 states), a cluster of 2-16 CTAs; its gradient epilogue
# holds a frame's V posteriors in shared memory.
LOSS_MAX_THREADS = 512
LOSS_HALO = 32
LOSS_CLUSTERS = (2, 4, 8, 16)
CTC_LOSS_MAX_LABELS = LOSS_CLUSTERS[-1] * (LOSS_MAX_THREADS - LOSS_HALO) - 1
CTC_LOSS_MAX_VOCAB = 8192
# The default plan, set from chip_smoke.py --lattice's sweep of every layout
# at every training shape on the H100: a group a row up to LOSS_GROUP_WARPS
# warps (it won at every shape of up to 4 warps, and lost to the clusters at
# every shape of 6 or more); past that the largest cluster whose CTAs for
# all B rows fit one a streaming multiprocessor (within 1% of the fastest
# cluster at every shape), or the smallest cluster that holds the row.
LOSS_GROUP_WARPS = 4
LOSS_CLUSTER_CTAS = 132


@dataclass(frozen=True)
class LossPlan:
    """The loss kernels' layout of a launch: `warps` warps a block (a
    cluster CTA's, its halo's included), `cluster` CTAs a row, `grid`
    blocks."""
    variant: str           # "warp", "group" or "cluster"
    warps: int
    cluster: int
    grid: int

    def describe(self) -> str:
        where = (f"{self.cluster} CTAs of {self.warps} warps a row, a halo's included"
                 if self.cluster > 1 else f"a block of {self.warps} warp(s) a row")
        return f"{self.variant} ({where}, grid {self.grid})"


def _loss_slice(n_pad: int, cluster: int) -> int:
    """A cluster CTA's states of a row of n_pad labels: ceil((N + 1) / C) in
    whole warps, at least a halo's (csrc/ctc_loss.cu slice_states)."""
    return max(32 * _warps_for(-(-(n_pad + 1) // cluster)), LOSS_HALO)


def loss_plan(n_pad: int, b: int, variant: str | None = None,
              cluster: int | None = None) -> LossPlan:
    """The training loss kernels' layout for B rows of labels padded to
    n_pad, a pure function of these host shapes (no length is read: no host
    sync). By default "warp" where the N + 1 state pairs fit one warp,
    "group" (one block a row) up to LOSS_GROUP_WARPS warps, else "cluster":
    the largest of LOSS_CLUSTERS that holds the row with B times its CTAs
    at most LOSS_CLUSTER_CTAS, or the smallest that holds it. `variant` (and
    for "cluster" `cluster`, its CTAs a row) asks for one of them. Raises
    ValueError where the layout cannot hold the states."""
    if n_pad < 0 or b < 0:
        raise ValueError(f"ctc_loss: N = {n_pad}, B = {b} must not be negative")
    if b > _MAX_GRID_Y:
        raise ValueError(f"ctc_loss: B = {b} rows do not fit one launch")
    states = n_pad + 1
    if variant is None:
        variant = ("warp" if states <= 32 else
                   "group" if _warps_for(states) <= LOSS_GROUP_WARPS else "cluster")
    if variant == "warp":
        if states > 32:
            raise ValueError(f"ctc_loss: labels padded to {n_pad} do not fit one warp")
        return LossPlan("warp", 1, 1, b)
    if variant == "group":
        warps = _warps_for(states)
        if 32 * warps > LOSS_MAX_THREADS:
            raise ValueError(f"ctc_loss: labels padded to {n_pad} do not fit one block")
        return LossPlan("group", warps, 1, b)
    if variant != "cluster":
        raise ValueError(f"ctc_loss: no variant {variant!r}")
    fitting = [c for c in LOSS_CLUSTERS
               if LOSS_HALO + _loss_slice(n_pad, c) <= LOSS_MAX_THREADS]
    if cluster is None:
        if not fitting:
            raise ValueError(f"ctc_loss: labels padded to {n_pad} do not fit "
                             f"{LOSS_CLUSTERS[-1]} CTAs (at most {CTC_LOSS_MAX_LABELS})")
        cluster = max((c for c in fitting if b * c <= LOSS_CLUSTER_CTAS), default=fitting[0])
    elif cluster not in fitting:
        raise ValueError(f"ctc_loss: labels padded to {n_pad} do not fit a cluster of "
                         f"{cluster} CTAs (sizes {LOSS_CLUSTERS})")
    return LossPlan("cluster", 1 + _loss_slice(n_pad, cluster) // 32, cluster, b * cluster)


def _loss_lattice(x, enc_len, tokens, blank_id: int, log_epsilon: float) -> dict:
    """The forward recursion above on plain tensors: lp, the emissions and
    penalty terms, and the states after every frame (phis, emits: entry 0
    the initial state; T_run + 1 entries, T_run the longest row's frames)."""
    b, t, _v = x.shape
    n = tokens.shape[1]
    dev, dt = x.device, x.dtype
    tokens = tokens.to(dev, torch.long)
    enc_len = enc_len.to(dev, torch.long)
    lp = torch.log_softmax(x, dim=-1)                                   # optax normalizes again
    repeat = F.pad((tokens[:, :-1] == tokens[:, 1:]).to(dt), (0, 1))[:, :n]   # [B, N]
    c1 = log_epsilon * repeat                                           # emit -> phi
    c2 = log_epsilon * (1.0 - repeat)                                   # blank -> label side
    lb = lp[:, :, blank_id]                                             # [B, T]
    le = torch.gather(lp, 2, tokens[:, None, :].expand(b, t, n))        # [B, T, N]
    live = torch.arange(t, device=dev)[None, :] < enc_len[:, None]      # [B, T]
    phi = torch.full((b, n + 1), log_epsilon, dtype=dt, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, dtype=dt, device=dev)
    phis, emits = [phi], [emit]
    t_run = min(t, int(enc_len.max())) if b else 0
    for i in range(t_run):
        lbi = lb[:, i, None]
        pp = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], emit + c1)], dim=1)
        next_emit = torch.logaddexp(pp[:, :-1] + le[:, i], emit + le[:, i])
        next_phi = torch.cat([pp[:, :1] + lbi,
                              torch.logaddexp(pp[:, 1:] + lbi, emit + lbi + c2)], dim=1)
        keep = live[:, i, None]
        emit = torch.where(keep, next_emit, emit)
        phi = torch.where(keep, next_phi, phi)
        phis.append(phi)
        emits.append(emit)
    return {"lp": lp, "le": le, "lb": lb, "c1": c1, "c2": c2, "live": live,
            "phis": phis, "emits": emits}


def _final(phi, emit) -> torch.Tensor:
    """optax's last blank states: phi[k] after the last emit -> phi step."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], emit)], dim=1)


def ctc_loss_plain(x, enc_len, tokens, token_lens, blank_id: int,
                   log_epsilon: float = LOG_EPSILON) -> torch.Tensor:
    """Per-row CTC NLL [B] by optax.ctc_loss's recursion (see above): x
    [B, T, V] (normalized again here, as optax does), enc_len, tokens
    [B, N] and token_lens on x's device; finite on infeasible rows (about
    -log_epsilon times the frames short). Plain torch ops: autograd
    differentiates it too."""
    lat = _loss_lattice(x, enc_len, tokens, blank_id, log_epsilon)
    last = _final(lat["phis"][-1], lat["emits"][-1])
    return -last.gather(1, token_lens.to(x.device, torch.long)[:, None])[:, 0]


def ctc_loss_grad_plain(x, enc_len, tokens, token_lens, blank_id: int,
                        grad_loss) -> torch.Tensor:
    """d(sum_b grad_loss[b] * ctc_loss_plain(x)[b]) / dx, [B, T, V]: the
    adjoints of the recursion's states back over the frames (vectorized over
    rows and states), each lae's weights exp(arg - out) from the forward's
    states, then the posteriors gamma (a label's summed over its positions
    in increasing k, after the blank's) and g * (exp(lp) * sum gamma - gamma)."""
    lat = _loss_lattice(x, enc_len, tokens, blank_id, LOG_EPSILON)
    b, t, v = x.shape
    n = tokens.shape[1]
    dev, dt = x.device, x.dtype
    tokens = tokens.to(dev, torch.long)
    lens = token_lens.to(dev, torch.long)
    grad_loss = grad_loss.to(dev, dt).reshape(b)
    phis, emits, c1, c2 = lat["phis"], lat["emits"], lat["c1"], lat["c2"]
    rows = torch.arange(b, device=dev)
    has = lens > 0
    last = _final(phis[-1], emits[-1])[rows, lens]
    g_phi = torch.zeros_like(phis[-1])
    g_emit = torch.zeros_like(emits[-1])
    g_phi[rows, lens] = torch.where(has, torch.exp(phis[-1][rows, lens] - last), 1.0)
    if n:
        prev = (lens - 1).clamp(min=0)
        g_emit[rows, prev] = torch.where(has, torch.exp(emits[-1][rows, prev] - last), 0.0)
    one = torch.ones((b, 1), dtype=dt, device=dev)
    zero = torch.zeros((b, 1), dtype=dt, device=dev)
    labels = torch.arange(n, device=dev)[None, :] < lens[:, None]
    grad = torch.zeros_like(x)
    for i in reversed(range(len(phis) - 1)):
        p_prev, e_prev, p_cur, e_cur = phis[i], emits[i], phis[i + 1], emits[i + 1]
        le, lb = lat["le"][:, i], lat["lb"][:, i, None]
        pp = torch.cat([p_prev[:, :1], torch.logaddexp(p_prev[:, 1:], e_prev + c1)], dim=1)
        w_a = torch.exp(pp[:, :-1] + le - e_cur)
        w_b = torch.exp(e_prev + le - e_cur)
        w_c = torch.cat([one, torch.exp(pp[:, 1:] + lb - p_cur[:, 1:])], dim=1)
        w_d = torch.exp(e_prev + lb + c2 - p_cur[:, 1:])
        w_p = torch.cat([one, torch.exp(p_prev[:, 1:] - pp[:, 1:])], dim=1)
        w_l = torch.exp(e_prev + c1 - pp[:, 1:])
        g_a = g_emit * w_a
        g_pp = torch.cat([g_a, zero], dim=1) + g_phi * w_c
        gam_lab = torch.where(labels, g_a + g_emit * w_b, 0.0)
        gam_blk = g_phi * w_c + torch.cat([zero, g_phi[:, 1:] * w_d], dim=1)
        send = g_phi[:, 1:] * w_d + g_pp[:, 1:] * w_l
        keep = lat["live"][:, i, None]
        g_phi = torch.where(keep, g_pp * w_p, g_phi)
        g_emit = torch.where(keep, g_emit * w_b + send, g_emit)
        blank_sum = gam_blk.sum(dim=1)
        gam = torch.zeros((b, v), dtype=dt, device=dev)
        gam[:, blank_id] = blank_sum
        gam.scatter_add_(1, tokens, gam_lab)
        total = gam_lab.sum(dim=1) + blank_sum
        step = grad_loss[:, None] * (torch.exp(lat["lp"][:, i]) * total[:, None] - gam)
        grad[:, i] = torch.where(keep, step, 0.0)
    return grad


_LOSS_FWD_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
_LOSS_BWD_ARGTYPES = _LOSS_FWD_ARGTYPES[:13] + [ctypes.c_void_p] * 8


def _loss_layout(what, x, enc_len, tokens, token_lens, blank_id: int) -> None:
    """Raise where the kernels cannot take the inputs."""
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be float32 on the card, got {x.dtype}")
    if not 0 <= blank_id < x.shape[-1]:
        raise ValueError(f"{what}: blank {blank_id} outside the vocabulary")
    if tokens.shape[1] > CTC_LOSS_MAX_LABELS:
        raise ValueError(f"{what}: labels padded to {tokens.shape[1]} do not fit "
                         f"{LOSS_CLUSTERS[-1]} CTAs (one thread a state pair: at most "
                         f"{CTC_LOSS_MAX_LABELS} labels)")
    if x.shape[-1] > CTC_LOSS_MAX_VOCAB:
        raise ValueError(f"{what}: V = {x.shape[-1]} is past the kernel's "
                         f"{CTC_LOSS_MAX_VOCAB} classes")
    if any(a.device != x.device for a in (enc_len, tokens, token_lens)):
        raise ValueError(f"{what}: enc_len, tokens and token_lens must be on {x.device}")


def _loss_common(x, enc_len, tokens, token_lens, blank_id, plan: LossPlan
                 ) -> tuple[list, int]:
    """The launchers' leading arguments (shared by forward and backward: the
    inputs and the layout) and the current stream."""
    b, t, v = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return [x.data_ptr(), x.stride(0), x.stride(1), b, t, v, enc_len.data_ptr(),
            tokens.data_ptr(), token_lens.data_ptr(), tokens.shape[1], blank_id, plan.warps,
            plan.cluster], stream


def _loss_forward_kernel(x, enc_len, tokens, token_lens, blank_id, plan: LossPlan | None = None):
    """One launch of the forward (normalizer and links, then the alpha chain
    a row), laid out by `plan` (loss_plan's by default): the loss [B] and
    the workspaces the backward reads, the plan last."""
    b, t, _v = x.shape
    n = tokens.shape[1]
    plan = plan or loss_plan(n, b)
    norm = torch.empty((b, t, 2), dtype=torch.float32, device=x.device)
    em = torch.empty((b, t, n + 1), dtype=torch.float32, device=x.device)
    alpha = torch.empty((b, t, n + 1, 4), dtype=torch.float32, device=x.device)
    link = torch.empty((b, max(n, 1), 2), dtype=torch.int32, device=x.device)
    loss = torch.empty(b, dtype=torch.float32, device=x.device)
    args, stream = _loss_common(x, enc_len, tokens, token_lens, blank_id, plan)
    fn = kernels.function("ctc_loss", "tilawa_ctc_loss_forward", _LOSS_FWD_ARGTYPES)
    kernels.check(fn(*args, norm.data_ptr(), em.data_ptr(), alpha.data_ptr(), link.data_ptr(),
                     loss.data_ptr(), stream), "ctc_loss forward")
    kernels.LAUNCHES["ctc_loss"] += 1
    return loss, (norm, em, alpha, link, plan)


def _loss_backward_kernel(x, enc_len, tokens, token_lens, blank_id, grad_loss, norm, em,
                          alpha, link, plan: LossPlan):
    """One launch of the backward (the adjoint chain a row on the forward's
    layout, then the gradient epilogue a frame): the gradient [B, T, V]."""
    b, t, _v = x.shape
    n = tokens.shape[1]
    gam = torch.empty((b, t, n + 1, 2), dtype=torch.float32, device=x.device)
    grad = torch.empty_like(x, memory_format=torch.contiguous_format)
    grad_loss = grad_loss.to(torch.float32).reshape(b).contiguous()
    args, stream = _loss_common(x, enc_len, tokens, token_lens, blank_id, plan)
    fn = kernels.function("ctc_loss", "tilawa_ctc_loss_backward", _LOSS_BWD_ARGTYPES)
    kernels.check(fn(*args, grad_loss.data_ptr(), norm.data_ptr(), em.data_ptr(),
                     alpha.data_ptr(), link.data_ptr(), gam.data_ptr(), grad.data_ptr(),
                     stream), "ctc_loss backward")
    kernels.LAUNCHES["ctc_loss"] += 1
    return grad


class CTCLoss(torch.autograd.Function):
    """optax.ctc_loss per row, [B], and its gradient at x. A CPU tensor runs
    ctc_loss_plain and ctc_loss_grad_plain; a CUDA tensor runs the kernels,
    one launch forward and one backward, with no host sync."""

    @staticmethod
    def forward(ctx, x, enc_len, tokens, token_lens, blank_id):
        ctx.blank_id = blank_id
        if x.device.type == "cpu":
            ctx.save_for_backward(x, enc_len, tokens, token_lens)
            return ctc_loss_plain(x, enc_len, tokens, token_lens, blank_id)
        loss, (*work, plan) = _loss_forward_kernel(x, enc_len, tokens, token_lens, blank_id)
        ctx.save_for_backward(x, enc_len, tokens, token_lens, *work)
        ctx.plan = plan
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_loss):
        x, enc_len, tokens, token_lens, *work = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return (None,) * 5
        if x.device.type == "cpu":
            grad = ctc_loss_grad_plain(x, enc_len, tokens, token_lens, ctx.blank_id,
                                       grad_loss)
        else:
            grad = _loss_backward_kernel(x, enc_len, tokens, token_lens, ctx.blank_id,
                                         grad_loss, *work, ctx.plan)
        return grad, None, None, None, None


def ctc_loss(x: torch.Tensor, enc_len: torch.Tensor, tokens: torch.Tensor,
             token_lens: torch.Tensor, blank_id: int) -> torch.Tensor:
    """optax.ctc_loss per row → [B] (not normalized: callers divide), with
    its gradient at x through autograd. x [B, T, V] (f32 on the card;
    normalized again inside, as optax does), enc_len [B], tokens [B, N]
    (right-padded) and token_lens [B], all on x's device: the kernels read
    each row's lengths on the card, so a CUDA call makes no host sync. For
    a CUDA tensor the forward and the backward each launch
    csrc/ctc_loss.cu once (kernels.LAUNCHES["ctc_loss"]) or raise; for a
    CPU tensor they run ctc_loss_plain and ctc_loss_grad_plain. Labels up
    to CTC_LOSS_MAX_LABELS, laid out by loss_plan. Plain tensors only: a
    sharded caller passes its local rows."""
    kernels.plain_tensors("ctc_loss", x, enc_len, tokens, token_lens)
    if x.dim() != 3 or tokens.dim() != 2 or enc_len.shape != (x.shape[0],) \
            or tokens.shape[0] != x.shape[0] or token_lens.shape != (x.shape[0],):
        raise ValueError("ctc_loss: x must be [B, T, V], tokens [B, N], enc_len and "
                         "token_lens [B]")
    if x.device.type == "cuda":
        _loss_layout("ctc_loss", x, enc_len, tokens, token_lens, blank_id)
        if x.stride(-1) != 1:
            x = x.contiguous()
        enc_len, tokens, token_lens = (a.to(torch.int32).contiguous()
                                       for a in (enc_len, tokens, token_lens))
    elif x.device.type != "cpu":
        raise ValueError(f"ctc_loss runs on cuda or cpu tensors, got {x.device}")
    return CTCLoss.apply(x, enc_len, tokens, token_lens, blank_id)


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
