#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card
    python3 chip_smoke.py --bundles phoneme-heldout
                                 # from a copy holding exports/phoneme-int8 and
                                 # exports/heldout-int4 (see the end of this text)
    python3 chip_smoke.py --layouts 2x2,1x4,4x1
                                 # the multi-device phase alone on four cards
    python3 chip_smoke.py --lattice
                                 # the CTC kernels alone: the lattice at every
                                 # shape under each variant that fits, each
                                 # bitwise its plain version, and the training
                                 # loss at every training bucket under each
                                 # layout that holds it, timed
    python3 chip_smoke.py --lattice-compare _parent
                                 # this checkout's CTC kernels beside the port
                                 # in _parent (e.g. `git archive` of the parent
                                 # commit's tilawa_tpu_torch/, in an ignored
                                 # directory) at every lattice and loss shape

Phases (each prints its elapsed seconds; any failure exits non-zero
without the final line):

  1. device      card name, count, nvidia-smi name and power limit
  2. build       nvcc the five hand-written kernels (in parallel) for
                 sm_90a; ptxas registers / shared memory / spills
  3. kernels     each kernel against its plain PyTorch version on the card
                 at every shape the paths launch: the int4 and int8 layers
                 as the paths launch them (bf16 out, bias fused) and the
                 TPU kernels' f32 functions, with rows bitwise independent
                 of M (int4 also at the batched eval's M = 8·T, up to
                 6400, and at the distillation teacher's B·T of each of
                 its buckets, with per-forward sums at each bucket), and
                 the log-mel at every (B, N) the paths launch (B=8 at every
                 bucket of the batched eval, every training bucket), its
                 frames bitwise
                 independent of B and of their offset; int4 and the log-mel
                 also at the context sweep's M = B·T and (B, N); the CTC
                 lattice at the rerank's chunks (T 512, C 512, L_pad 128;
                 T 1024, C 64, L_pad 512), the phoneme shape (V 70, L_pad
                 3,072, a row at L 2,598), the tracker's C = 2, the chain
                 floor (one candidate of one token), chunks whose rows are
                 all live (LATTICE_CASES) and the batch form at B = 4
                 (equal +inf patterns, 1e-5, equal argmin); timings of
                 the kernel, the plain version and a one-call library
                 yardstick, the variant (ops/ctc.py lattice_plan) each shape
                 ran and its us a frame; the training CTC loss (forward and
                 backward) at every training bucket's B x T with v1's label
                 lengths, V 1,025 and the phoneme batches' V 70, and a
                 phoneme batch past 1,023 labels (CTC_LOSS_CASES): each
                 row's loss bitwise and gradient against the plain version
                 (CTC_LOSS_TOL, CTC_GRAD_TOL), two runs bitwise equal, the
                 layout (ops/ctc.py loss_plan), kernel, plain and
                 F.ctc_loss ms, the bound and the chain floor
  4. main path   champion-int4 Recognizer(tta=True).predict over wav clips
                 of benchmark/test_corpus (each must match the manifest),
                 plus the >25 s transcribe fallback; launch counters are
                 zeroed just before and read just after: one lattice launch
                 a scorer chunk, two recorded chunks replayed on the plain
                 lattice, every lattice call on the plain path timed beside
                 the kernel path's
  5. plain path  the same model with the plain ops on the card for one
                 clip: same collapsed greedy ids, max |Δ log-prob| printed
  6. trace       a short and a long clip's forward and predict on the host
                 clock, and each forward under torch.profiler: device busy
                 share, the kernels that take the device time, one quantized
                 matmul launch per product and no split-K sum kernel
  7. eval        c2c-direct-mixed-tta through the port's runner over every
                 v1 sample (counters zeroed just before, read just after):
                 every scored clip matches its manifest (recall, precision,
                 sequence accuracy 1.0), N >= 37, dispositions, latency
                 p50/mean/p90, TILAWA_PROFILE stage medians, one lattice
                 launch a scorer chunk, agreement with
                 the JAX package's recorded run; then the other registered
                 experiments over the wav clips, with no error
  8. batched     step 0 (two B=8 forward_batch_async calls make no
                 synchronizing call; behind a device sleep the host queues
                 the first one's early blocks while the device sleeps),
                 then batched_corpus_eval at B=8 over the eval's clips
                 (counters zeroed just before, read just after): the eval's
                 verses, recall and sequence accuracy 1.0, 189 int4
                 launches per forward; B=8 rows against B=1 (greedy ids
                 equal, max |Δ log-prob|); audio-s/s, stage times, peak
                 memory
  9. bench       python -m tilawa_tpu_torch.bench as a child process: its
                 JSON line whole, recall, seq_acc and batched recall 1.0
  10. streaming  stream6-int8 (int8 Dense): one forward's launches and its
                 profile as in "trace", then v1 clips
                 replayed through validate_streaming's
                 RecitationTracker in 300 ms chunks (each must score
                 sequence accuracy 1.0), with per-cycle forward, fusion
                 scoring and feed times; counters zeroed just before the
                 replay and read just after; one lattice launch a scorer
                 chunk, the scoring calls replayed on the plain lattice
  11. streaming  every decodable v1 clip (N >= 37) through validate_streaming
      corpus     on stream6-int8 in 300 ms chunks (counters zeroed just
                 before, read just after): each clip's final sequence equal
                 to the JAX package's live replay (eval/refs/streaming_v1.json;
                 the 2026-08-21 record printed beside it); the STREAM_IDS at
                 sequence accuracy 1.0; 189 int8 + 1 log-mel a forward; one
                 lattice launch a scorer chunk
  12. streaming  the streaming corpus with the window TTA on
      tta        (pipeline/predict.py STREAM_TTA, put back after): each
                 window and its 0.9x variant in one two-row forward_batch
                 (counters zeroed just before, read just after): every
                 clip's emissions and final sequence equal to the JAX
                 package's replay with its TTA on
                 (eval/refs/streaming_tta_v1.json) but for named near ties
                 (a clip that decides as JAX once its all-zero windows get
                 the JAX package's features, ROADMAP C.11; or replays that
                 part at a pick one token from the other choice); TTA
                 cycles and kept variants beside JAX's; the two-row
                 forward_batch's p50/p90 beside phase 11's plain forward;
                 189 int8 + 1 log-mel a forward_batch call; one lattice
                 launch a scorer chunk, the calls replayed on the plain
                 lattice
  13. cache      StreamingEncoderCache on a window over 16 s, cold and
                 with its tail grown by 1 s, against forward_long (ids,
                 t_valid, log-probs), and the ops whose row 0 changes with
                 the batch size at equal input
  14. server     the port's WebSocket server in-process on 127.0.0.1
                 (TILAWA_CHECKPOINT=exports/stream6-int8, tracker engine):
                 two ws_client streams at once, each of which must get a
                 verse_match for its clip's verse; then the port's ws_bench
                 with two clients over the four streaming clips, flat out,
                 each at sequence accuracy 1.0, per-message latency p50/p90
  15. champion   the trace's two clips' forward and predict once more, in
      again      the process state the phases before leave behind
  16. train      train.finetune's recipe at full width from the dequantized
                 champion-int4 over bucketed v1 batches, TRAIN_STEPS steps
                 (in a temporary directory outside the tree), finetune's
                 own log_every: per step the bucket, loss, step ms (CUDA
                 events), audio-s/s, MFU and launches; peak memory; the
                 synchronizing calls a step (set_sync_debug_mode "warn");
                 finite losses, nothing moved by step 0 (lr 0), parameters
                 moved by step 1, frozen BatchNorm stats, one log-mel
                 and two ctc_loss launches a step, no int4, no sync from
                 the port's code or from any CTC loss; then
                 train/fit_report.py over the v1 clips up to
                 FIT_REPORT_MAX_S from the trained checkpoint: one
                 ctc_loss launch a batch, finite losses
  17. train vs   one step on a fixed v1 batch (dropout 0, no SpecAugment)
      plain      with the log-mel kernel and with the plain log-mel, f32 and
                 bf16 compute: |Δ loss| and the largest per-leaf
                 max|Δg|/max|g|, in f32 gated by the same deltas of the
                 plain step with ±MEL_TOL noise on its log-mel (bf16
                 printed); the plain step run twice bitwise equal in both;
                 then one bf16 step under torch.profiler
  18. distill    train_distill: student the dequantized champion, teacher
                 champion-int4 on the int4 kernel, DISTILL_STEPS steps over
                 distill_batches(v1): KL, auxiliary CTC, step ms, syncs as
                 in "train"; 189 int4 launches a step (the teacher), 2
                 log-mel and 2 ctc_loss; before it, the KL of teacher and student on the
                 first batch's full clips, within SAME_WEIGHTS_KL
  19. export     export_bundle of the train phase's checkpoint as int4:
                 verify_bundle, the server's sha256 check, and
                 Recognizer(tta=True) on the 8 clips at 1.0 with 189 int4
                 launches a forward
  20. families   on champion-int4: fastconformer-quran-lm-fusion through the
                 runner over every v1 sample (real acoustics, no error, every
                 clip the JAX package's recorded run gets right right here),
                 then two-stage and the six pruned-ctc variants over the
                 wav clips (no error; recall, sequence accuracy, p50, the
                 CTC lattice's ms per clip beside the plain lattice's); every
                 run with 11·L + 2 int4 and one log-mel launch a forward of
                 its L-block runtimes and one lattice launch a scorer chunk
                 (counters zeroed just before each, read just after);
                 heldout raises FileNotFoundError where its bundle is not in
                 the copy
  21. harnesses  the context sweep over the wav clips (launches as in 20;
                 every row of a sweep's B-row forward bitwise the same row
                 forwarded alone at the same bucket), run_stability of the
                 champion experiment (3 repeats: no flaky sample),
                 tracker_oracle over v1 (host only, no launch; its policy
                 ceiling), analyze and compare over this run's eval and
                 streaming corpus rows; the sweep rows whose greedy ids move
                 at the row's own smaller bucket are named
  22. phoneme    fastconformer-phoneme on oracle acoustics (host renders from
      oracle     seed 0) through the runner over every v1 manifest row, the
                 CTC rerank off and on (its lattice on the card, timed):
                 decisions equal to the JAX package's (eval/refs/phoneme_v1.json),
                 rows labelled acoustics "oracle", no kernel launched but the
                 lattice (one a scorer chunk, timed beside the plain lattice)
  23. phoneme    train.phoneme at full width from the dequantized
      train      champion-int4 with a fresh 70-class head, PHONEME_TRAIN_STEPS
                 steps in a temporary directory: finite losses, one log-mel
                 and two ctc_loss launches a step, the sync census of
                 "train"; the head is
                 [512, 70] lecun normal, bias 0; the checkpoint loads in
                 EncoderRuntime and gives [T, 70] log-probs
  24. multi-     the sharded step (tilawa_tpu_torch/parallel/) in a child
      device     process with its own timeout that is rank 0 of a world-size-1
                 NCCL mesh (data 1 x model 1; NCCL refuses two ranks on one
                 card): the dequantized champion at full width (finetune's
                 dropout and SpecAugment, live BatchNorm) on "train vs
                 plain"'s v1 batch, MD_STEPS sharded steps against two
                 plain make_train_step runs from the same variables and
                 generators: losses, per-step gradients, parameters and
                 BatchNorm stats within MD_FLOOR_FACTOR times the plain-twice
                 floor (0: bitwise); the same in f32, its distance from an
                 f64 run within MD_FLOOR_FACTOR times the plain f32 run's,
                 its parameters equal to a replay of its own gradients; one
                 log-mel, two ctc_loss and no quantized launch a step, no
                 synchronizing call from the CTC loss in a sharded bf16
                 step (the census of "train"); each path's step ms
                 (CUDA events and host clock, in turns); the sharded forward
                 + CTC rerank of 6 transcripts (one batch lattice launch)
                 equal to the unsharded model's scores. Then, on the
                 host's CPU and labelled so, the 8-rank gloo dry run (data
                 4 x model 2) and the JAX package's line

--layouts DATAxMODEL,... (e.g. 2x2,1x4,4x1 on a four-card machine) runs
phase 24 alone, one NCCL rank a card, one mesh a layout, each using every
card: the f32 gates hold on every layout; where a sum is split the bf16
step flips roundings through the 17 blocks, so its deltas are printed.
It ends with the {"multi_device": ...} line (every number of the phase),
nvidia-smi's line and the ok line.

--bundles phoneme-heldout replaces phases 4-24 (it fails at once if either
bundle is absent) with three phases:
  phoneme bundle   one phoneme-int8 forward (189 int8 + 1 log-mel launches, 70
                   classes); the runner over every decodable v1 clip, rerank
                   off and on: verses equal to the JAX package's live run
                   (eval/refs/phoneme_v1.json) but for named near ties, 189
                   int8 + 1 log-mel a forward, one lattice launch a scorer
                   chunk
  heldout bundle   heldout-int4 with TTA through the runner: verses equal to
                   the JAX package's live run (eval/refs/heldout_v1.json) but
                   for named near ties, and to the 2026-08-21 record but where
                   a near tie or today's JAX run differs from it; 189 int4 +
                   1 log-mel a forward, one lattice launch a scorer chunk
  phoneme          train.phoneme --init exports/phoneme-int8, CONTINUE_STEPS
  continuation     steps: its trained head kept, as in 23
Its last lines: the wall, {"bundles": ...}, nvidia-smi's line, the kernels
line and the ok line.

The last lines: the wall, one JSON object {"train": {...}} (step ms, audio-s/s,
peak bytes, training MFU, distill step ms, the kernel-vs-plain deltas, the
multi-device phase's numbers, the card and its power limit), nvidia-smi's name and power limit, one JSON
object with every kernel's numbers (`launches`: the eval phase's run,
the train phase's for ctc_loss;
`train_launches`: the train phase's log-mel and the distill teacher's
int4; `path_launches`: one entry per path of phases 10–12, 16, 18 and 20–24; the
int8 entry's `phoneme_head`: the (512, 70) head's times per M; the lattice
entry's `paths`: kernel and plain per-call times of each path), and
{"ok": true, "device": {...}}. A line before them says that the bundle
section runs under --bundles.
Imports nothing of JAX, flax, msgpack or tilawa_tpu.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CORPUS = ROOT / "benchmark" / "test_corpus"
CLIPS = (
    "retasy_000.wav", "retasy_003.wav", "retasy_010.wav", "retasy_016.wav",
    "retasy_017.wav", "retasy_024.wav", "multi_113_001_005.wav",
    "long_033_056.wav",
)
LONG_CLIP = "multi_114_001_006.wav"   # 41 s: takes the 25 s transcribe fallback
STREAM_BUNDLE = ROOT / "exports" / "stream6-int8"
# v1 clips the JAX package's tracker gets right on stream6-int8 (sequence
# accuracy 1.0 in its recorded v1 streaming run and on the CPU)
STREAM_IDS = ("retasy_003", "retasy_010", "multi_103_001_003", "ref_033056")
SERVER_CLIPS = ("retasy_003.wav", "retasy_010.wav")
SEED = 0
DEVICE = "cuda"
MAIN_EXPERIMENT = "c2c-direct-mixed-tta"
OTHER_EXPERIMENTS = ("c2c-direct-mixed", "fastconformer-zeroshot", "ctc-alignment",
                     "oracle", "oracle-hard")
# the v1 wav clips present (N=37); 44 where mp3/m4a decode as well
MIN_EVAL_CLIPS = 37
# the JAX package's recorded run of MAIN_EXPERIMENT over v1 (44 clips at 1.0)
JAX_RECORDED_RUN = ROOT / "benchmark" / "results" / "2026-08-21_095830.json"
# ... of fastconformer-quran-lm-fusion over v1 (real acoustics; exactly right on 35
# of the 37 wav clips): every clip it gets right must be right on the port
JAX_LM_FUSION_RUN = ROOT / "benchmark" / "results" / "2026-08-21_142224.json"
LM_FUSION = "fastconformer-quran-lm-fusion"
# ... of the tracker on stream6-int8 over v1 in 300 ms chunks: it predates the
# tracker's current Viterbi, so it is printed beside the gate, which holds the
# replay to the JAX package's live replay (tilawa_tpu_torch/eval/jax_refs.py)
JAX_STREAM_RUN = ROOT / "benchmark" / "results" / "2026-08-21_204047.json"
# ... of heldout over v1 (TTA; right on 2 of 44, both m4a): printed beside the gate,
# which holds the card to the JAX package's live run (jax_refs.HELDOUT_REF)
JAX_HELDOUT_RUN = ROOT / "benchmark" / "results" / "2026-08-21_140720.json"
# ... of fastconformer-phoneme on phoneme-int8 over v1 (seq-acc 0.7273): printed
# beside the gate, which holds the card to jax_refs.PHONEME_REF
JAX_PHONEME_RUN = ROOT / "benchmark" / "results" / "2026-08-21_222020.json"
STABILITY_REPEATS = 3
PHONEME = "fastconformer-phoneme"
PHONEME_BUNDLE = ROOT / "exports" / "phoneme-int8"
HELDOUT_BUNDLE = ROOT / "exports" / "heldout-int4"
# --bundles NAME: the section run from a copy of the repository that holds
# these bundles in place of champion-int4 and stream6-int8
BUNDLE_SECTIONS = {"phoneme-heldout": (PHONEME_BUNDLE, HELDOUT_BUNDLE)}
PHONEME_TRAIN_STEPS = 6     # train.phoneme's swap-head path from champion-int4
CONTINUE_STEPS = 3          # train.phoneme --init exports/phoneme-int8 (continuation)
HEAD_STD_BAND = 0.03        # |std of the fresh head / (1/sqrt(512)) - 1| (512 x 70 draws)
# "multi-device": MD_STEPS compared steps a run, then MD_TIMED_STEPS timed steps a
# path; a sharded run within MD_FLOOR_FACTOR times its floor (a largest-of-many-elements
# delta of one pair of runs spreads by tens of percent from one pair to the next; a
# floor of 0 asks for bitwise equality): on one rank the plain bf16 step run twice, on
# any mesh the plain f32 step's distance from f64; the f32 parameters within
# MD_REPLAY_RTOL·max|p| of a single-process replay of their own gradients (AdamW steps
# an element whose gradient is rounding noise by ±lr in any two runs that order their
# sums differently, so parameters are not held elementwise to an independent run:
# tests/test_torch_parallel.py's PARAM_RTOL); scores within SCORE_RTOL·max|score|
# (tests/test_torch_parallel.py's bound)
MD_STEPS = 2
MD_TIMED_STEPS = 6
MD_FLOOR_FACTOR = 2.0
MD_REPLAY_RTOL = 1e-6
SCORE_RTOL = 1e-5
BENCH_BUDGET_S = 300
WS_CLIENTS = 2
CHAMPION = ROOT / "exports" / "champion-int4"
TRAIN_STEPS = 6        # train.finetune's recipe, steps at lr 0 .. 5·3e-5/100
DISTILL_STEPS = 4
FIT_REPORT_MAX_S = 8.0  # train/fit_report.py on the card: v1's clips in the 8 s bucket
GRAD_FLOOR = 1e-3      # train vs plain: leaves under this share of the largest gradient
                       # hold rounding noise and are not compared
SAME_WEIGHTS_KL = 1e-3  # KL(teacher || student) per valid frame on full clips when both
                        # hold the champion's weights (int4 kernel vs the dequantized bf16
                        # matmuls: same operands, f32 sums in other orders, bf16 roundings
                        # flipped through 17 blocks): 2.9e-5 read on an H100 (PERF.md), the
                        # bound ~35x that; dropout 0.1 on the student alone gives ~1.4
# step 0: two B=8 forwards at NO_SYNC_BUCKET make no synchronizing call;
# behind a device sleep of NO_SYNC_SLEEP_S (torch.cuda._sleep counts SM
# cycles, ~1.98e9 a second on an H100 SXM at full clock) the host reaches
# block HOOK_BLOCK of the first within NO_SYNC_SHARE of the sleep, the
# device still asleep; the two forwards' host and device times are printed
# at NO_SYNC_BUCKET and BUSY_BUCKET
NO_SYNC_BUCKET = 512000
BUSY_BUCKET = 1024000
NO_SYNC_SLEEP_S = 0.3
SLEEP_CYCLES_PER_S = 1.98e9
NO_SYNC_SHARE = 0.5
HOOK_BLOCK = 2

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core and f32 CUDA-core operations/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12
# the special-function units (MUFU: the exp2 and log2 under expf and log1pf):
# 16 results a clock on each of the 132 SMs (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) at the H100
# SXM's 1.98 GHz boost clock
MUFU_OPS_S = 132 * 16 * 1.98e9

INT4_TOL = 1e-5     # max|Δ| ≤ INT4_TOL · max|ref|: same bf16 operands, f32 sums in another
                    # order; a W left unrounded to bf16 errs by ~1e-3 · max|ref| (checked below)
INT8_TOL = 1e-5     # scale in W (_int8_kernel's order): as INT4_TOL
INT8_ULP2 = 2.0 ** -6  # scale after (Int8Dense's order), bf16 out: a last-bit flip of the
                       # rounded product bf16(acc) (f32 sums in another order) moves y =
                       # bf16(bf16(acc)·s) by up to two bf16 ulps, 2^-6·|y|; each element is
                       # held to that (+ INT8_TOL · max|ref| for sums that cancel) and
FLIP_RATE = 1e-2       # under 1% of the elements may differ at all; a product left
                       # unrounded before the scale differs in ~25% (checked below)
CACHE_TOL = 1e-5    # max|Δ log-prob| of the streaming cache against forward_long: the
                    # reference's contract (tests/test_runtime_long.py)
MEL_TOL = 2e-3      # max|Δ log-mel|: the kernel's radix-4 FFT vs cuFFT's rfft in f32, sums in
                    # other orders (tests/test_frontend.py holds the JAX fused kernel to the same
                    # bound against its rfft path)
# (B, N) of the log-mel launches on the paths: forward's buckets, the TTA
# pair, forward_long's and the cache's padded batches, and an odd N
MEL_SHAPES = ((1, 64000), (1, 128000), (1, 256000), (1, 512000), (2, 64000),
              (2, 256000), (8, 256000), (1, 12345),
              (8, 64000), (8, 128000), (8, 512000), (8, 1024000))   # the batched eval's
MEL_OFFSETS = (1, 2, 3, 5, 97)   # frame offsets for the bitwise shift check
LATTICE_TOL = 1e-5  # the CTC lattice kernel against its plain version, rtol and atol on the
                    # finite scores (+inf patterns and each call's argmin equal): the same f32
                    # recursion with IEEE expf/log1pf in the same order; fast math or another
                    # order of the two logaddexps drifts scores beyond it
# (label, T, V, C, L_pad, t_valid, live lengths) of the lattice calls the
# paths make: the champion rerank's 512-row chunk at L_pad 128 (most rows
# padding, a row at exactly 2L+1 = t_valid, runs of a repeated token), with
# infeasible rows, and at t_valid 1; a 64-row chunk at L_pad 512; the
# phoneme rerank's V 70 at L_pad 3,072 (a row at L 2,598, feasible at the
# 8192-frame bucket); the tracker's two-candidate calls; one candidate of
# one token, whose time over t_valid - 1 frames is the kernel's own floor a
# frame (its dependent chain). Then chunks whose rows are all live, as
# score_token_lists sends them (it keeps only feasible candidates): 512 at
# L_pad 128 and at L_pad 512 with t_valid 304 (the champion rerank's
# calls), 512 at L_pad 512 with t_valid 1100 (a clip past 1,025 frames:
# lengths up to 512), a phoneme rerank call (64-row bucket, 40 live, L_pad
# 512, t_valid 690) and 64 rows of the phoneme bucket 3,072 (L 2,561 to
# 2,598).
LATTICE_CASES = (
    ("rerank chunk", 512, 1025, 512, 128, 257, (128, 127, 100, 64, 40, 17, 5, 3, 2, 1)),
    ("infeasible rows", 512, 1025, 512, 128, 201, (128, 101, 100, 99, 50, 1)),
    ("t_valid 1", 512, 1025, 512, 128, 1, (1, 5, 128)),
    ("L_pad 512", 1024, 1025, 64, 512, 1000, (499, 500, 512, 300, 128, 129, 7)),
    ("phoneme", 8192, 70, 64, 3072, 5197, (2598, 2599, 1500, 700, 64, 1)),
    ("tracker", 512, 1025, 2, 128, 300, (6, 4)),
    ("chain floor", 512, 1025, 1, 128, 257, (1,)),
    ("dense 128", 512, 1025, 512, 128, 304, tuple(8 + 120 * r // 511 for r in range(512))),
    ("dense 512", 512, 1025, 512, 512, 304, tuple(129 + 22 * r // 511 for r in range(512))),
    ("dense 512 long", 2048, 1025, 512, 512, 1100,
     tuple(129 + 383 * r // 511 for r in range(512))),
    ("phoneme call", 1024, 70, 64, 512, 690, tuple(129 + 215 * r // 39 for r in range(40))),
    ("phoneme dense", 8192, 70, 64, 3072, 5197, tuple(2561 + 37 * r // 63 for r in range(64))),
)
LATTICE_BATCH_T_VALID = (512, 257, 100, 1)   # the batch form's B = 4 rows
CTC_LOSS_LAUNCHES_PER_STEP = 2   # the training loss: one launch forward, one backward
CTC_LOSS_TOL = 1e-5   # the training loss's kernels against their plain version: each row's
CTC_GRAD_TOL = 1e-4   # loss relative, each row's gradient max|Δ| over its max|g| (the same f32
                      # recursion, IEEE expf/log1pf in the same order, sums of the softmax
                      # and of the posteriors in other orders); the CPU tests hold the plain
                      # version to jax.value_and_grad of optax.ctc_loss at the same bounds
# (label, B, T, V, L_pad, L_max) of the training losses: every train.data.BUCKETS batch
# (B x T encoder frames, 12.5 a second) with labels as long as v1's bucketed batches give
# them (bucketed_corpus_batches: L_pad the bucket's token pad, the longest label rounded up
# to 16), V 1,025; no v1 clip falls in the 96 s and 160 s buckets, so theirs take the 64 s
# bucket's density, 102 labels in 800 frames. Then train.phoneme's batches
# (phoneme_corpus_batches over v1, V 70: its pads and longest rows; 160 s at the 64 s
# bucket's density, 343 in 800). Read from v1 with those generators over 400 batches.
# Last, a phoneme batch past 1,023 labels: a fast reciter's ~9.4 phonemes a second
# inside the 160 s bucket (row 0 1,500 labels, feasible; row 1 1,125, infeasible).
CTC_LOSS_CASES = (
    ("text 8 s", 16, 100, 1025, 32, 19),
    ("text 12 s", 12, 150, 1025, 48, 41),
    ("text 16 s", 8, 200, 1025, 32, 25),
    ("text 24 s", 6, 300, 1025, 48, 38),
    ("text 32 s", 4, 400, 1025, 48, 42),
    ("text 48 s", 3, 600, 1025, 48, 39),
    ("text 64 s", 2, 800, 1025, 112, 102),
    ("text 96 s", 1, 1200, 1025, 160, 153),
    ("text 160 s", 1, 2000, 1025, 256, 255),
    ("phoneme 8 s", 16, 100, 70, 64, 59),
    ("phoneme 12 s", 12, 150, 70, 160, 149),
    ("phoneme 16 s", 8, 200, 70, 80, 71),
    ("phoneme 24 s", 6, 300, 70, 160, 154),
    ("phoneme 32 s", 4, 400, 70, 192, 180),
    ("phoneme 48 s", 3, 600, 70, 176, 175),
    ("phoneme 64 s", 2, 800, 70, 352, 343),
    ("phoneme 160 s", 1, 2000, 70, 864, 858),
    ("phoneme 160 s fast", 2, 2000, 70, 1536, 1500),
)


def mel_shapes() -> tuple[tuple[int, int], ...]:
    """MEL_SHAPES, the (B, N) of every train.data.BUCKETS batch (the
    training forwards, and distillation's teacher and student: its buckets
    are those up to train.distill.MAX_BUCKET_S) and the context sweep's."""
    from tilawa_tpu_torch.train.data import BUCKETS

    return tuple(dict.fromkeys((*MEL_SHAPES, *((bs, int(sec * 16000)) for sec, bs in BUCKETS),
                                *((b, n) for b, n, _t in sweep_shapes()))))


@functools.lru_cache(maxsize=1)
def sweep_shapes() -> tuple[tuple[int, int, int], ...]:
    """(B, N, T) of the context sweep's forward of each of CLIPS: its
    prefix cuts and the clip as B rows padded to the clip's audio bucket N
    (T encoder frames)."""
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.context_sweep import sweep_pieces
    from tilawa_tpu_torch.pipeline.runtime import bucket_length
    from tilawa_tpu_torch.train.train import encoder_lengths

    out = []
    for clip in CLIPS:
        _keys, pieces = sweep_pieces(load_audio(CORPUS / clip))
        n = bucket_length(max(len(p) for p in pieces))
        out.append((len(pieces), n, int(encoder_lengths([n])[0])))
    return tuple(dict.fromkeys(out))

# The champion's int4 products per forward, (K, N, launches), at M encoder
# rows (pos runs over the 2T-1 relative positions).
INT4_SHAPES = (
    ("proj", 2560, 512, 1),
    ("q/k/v/out", 512, 512, 4 * 17),
    ("pos", 512, 512, 17),
    ("pw1", 512, 1024, 17),
    ("pw2", 512, 512, 17),
    ("lin1", 512, 2048, 2 * 17),
    ("lin2", 2048, 512, 2 * 17),
    ("ctc_head", 512, 1025, 1),
)
INT4_LAUNCHES_PER_FORWARD = sum(s[3] for s in INT4_SHAPES)


def int4_launches(num_layers: int) -> int:
    """int4 products of a forward of `num_layers` blocks: INT4_SHAPES holds
    17 blocks' (11 a block) and the projection and CTC head once each."""
    return sum(count if count == 1 else count // 17 * num_layers
               for _name, _k, _n, count in INT4_SHAPES)


NO_BIAS = frozenset({"pos"})   # the one Dense built with use_bias=False
# stream6-int8 runs the same 189 products as Int8Dense layers
INT8_LAUNCHES_PER_FORWARD = INT4_LAUNCHES_PER_FORWARD
M_MAIN = 50          # encoder frames of the 64000-sample (4 s) bucket
# encoder frames of the audio buckets the main and streaming paths reach:
# 4, 8, 16 and 32 s (clips and windows up to 30 s; 25 s transcribe windows)
PATH_T = (50, 100, 200, 400)


# The phoneme runner forwards whole clips at their bucket (no long chunking):
# PATH_T and the 41 s clip's 1,024,000 samples; its CTC head is (512, 70).
PHONEME_T = (*PATH_T, 800)
PHONEME_HEAD = ("phoneme_head", 512, 70, 1)


def int8_ms(name: str) -> tuple[int, ...]:
    """The rows M an int8 product runs at: stream6-int8's windows and the
    phoneme bundle's clips, B = 1 (pos at 2T-1)."""
    return tuple(2 * t - 1 for t in PHONEME_T) if name == "pos" else PHONEME_T


# The batched corpus eval: B=8 rows at the encoder frames of the 64000 …
# 1024000-sample buckets (pos stays one [2T-1, D] product per forward).
BATCH = 8
BATCH_T = (50, 100, 200, 400, 800)


def path_ms(name: str) -> tuple[int, ...]:
    """The rows M a product runs at on the per-clip paths (pos at 2T-1)."""
    return tuple(2 * t - 1 for t in PATH_T) if name == "pos" else PATH_T


def batched_m(name: str, t: int) -> int:
    """The rows M a product runs at in a batched forward of T frames."""
    return 2 * t - 1 if name == "pos" else BATCH * t


def distill_ms(name: str) -> tuple[int, ...]:
    """The rows M a product runs at in the distillation teacher's forward
    of each distill bucket's batch: B·T (pos at 2T-1)."""
    from tilawa_tpu_torch.train.data import BUCKETS
    from tilawa_tpu_torch.train.distill import MAX_BUCKET_S
    from tilawa_tpu_torch.train.train import encoder_lengths

    out = []
    for sec, bs in BUCKETS:
        if sec <= MAX_BUCKET_S:
            t = int(encoder_lengths([int(sec * 16000)])[0])
            out.append(2 * t - 1 if name == "pos" else bs * t)
    return tuple(out)


def sweep_m(name: str, b: int, t: int) -> int:
    """The rows M a product runs at in the context sweep's B-row forward."""
    return 2 * t - 1 if name == "pos" else b * t


def int4_ms(name: str) -> tuple[int, ...]:
    """Every M the champion's products run at: per clip, batched, in the
    distillation teacher and in the context sweep (pruned and two-stage
    forwards run at the per-clip M)."""
    return tuple(sorted(set(path_ms(name)) | {batched_m(name, t) for t in BATCH_T}
                        | set(distill_ms(name))
                        | {sweep_m(name, b, t) for b, _n, t in sweep_shapes()}))


class PhaseFailed(Exception):
    pass


_T0 = time.perf_counter()


@contextmanager
def phase(name: str):
    t = time.perf_counter()
    print(f"== {name}", flush=True)
    try:
        yield
    except Exception as e:  # noqa: BLE001 — every phase failure ends the run
        traceback.print_exc()
        raise PhaseFailed(f"{name}: {e}") from e
    print(f"== {name} ok in {time.perf_counter() - t:.1f} s "
          f"(total {time.perf_counter() - _T0:.1f} s)", flush=True)


def time_cuda(torch, fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() with CUDA events, L2 flushed before each
    call (the main path finds each layer's weights cold). The flush (a 1 GiB
    memset, ~0.3 ms on the card) also covers the host's enqueue of fn, so
    the events time the device and not a host that falls behind."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def quant_bound_ms(m: int, k: int, n: int, weight_bytes: int, scale_bytes: int,
                   out_bytes: int, bias: bool) -> tuple[float, str]:
    """x in bf16, the quantized weights and their scales read once, the bias
    (f32) read once where the layer has one, the output written once; the
    products at the bf16 tensor-core rate."""
    nbytes = m * k * 2 + weight_bytes + scale_bytes + (n * 4 if bias else 0) + m * n * out_bytes
    flops = 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int4_bound_ms(m: int, k: int, n: int, out_bytes: int, bias: bool) -> tuple[float, str]:
    return quant_bound_ms(m, k, n, (k // 2) * n, (-(-k // 32)) * n * 4, out_bytes, bias)


def int8_bound_ms(m: int, k: int, n: int, out_bytes: int, bias: bool) -> tuple[float, str]:
    return quant_bound_ms(m, k, n, k * n, n * 4, out_bytes, bias)


def mel_bound_ms(b: int, n: int, t: int, fb_nonzeros: int) -> tuple[float, str]:
    """What the log-mel function needs: the audio read once and the
    log-mels written once; per frame a 512-point real FFT (2.5·n·log2 n),
    the power (3 per bin), the mel step over the filterbank's non-zero
    weights (2 each) and the log (1 per mel)."""
    nbytes = b * n * 4 + b * t * 80 * 4
    flops = b * t * (2.5 * 512 * 9 + 3 * 257 + 2 * fb_nonzeros + 80)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bits(torch, t):
    """The tensor's bit patterns, for bitwise comparison."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def check_rows(torch, what: str, fn, x, ms) -> None:
    """Row invariance: fn(x[:m]) is bit for bit the first m rows of fn(x)
    for every m (the sum order of a row must not depend on M)."""
    full = fn(x)
    for m in ms:
        if not torch.equal(bits(torch, fn(x[:m])), bits(torch, full[:m])):
            raise AssertionError(f"{what}: rows of M={m} differ from the same rows "
                                 f"of M={x.shape[0]}")


def check_layer(torch, what: str, out, ref, ref_nobias, blind) -> tuple[int, int, float]:
    """A fused bf16 layer epilogue against its plain version. A last-bit
    flip of the rounded product (f32 sums in another order) moves the
    pre-bias value u by up to two bf16 ulps (INT8_ULP2·|u|), and the bias
    add can round that one ulp of y further: each element is held to
    INT8_ULP2·(|u| + |y|) + INT8_TOL·max|y| and under FLIP_RATE of them may
    differ at all. `blind`, an epilogue that adds the bias to the unrounded
    product, must fail the flip gate (None where there is no bias)."""
    out, ref, u = out.float(), ref.float(), ref_nobias.float()
    delta = (out - ref).abs()
    n_flips = int((delta > 0).sum())
    bound = INT8_ULP2 * (u.abs() + ref.abs()) + INT8_TOL * float(ref.abs().max())
    if not bool((delta <= bound).all()) or n_flips > FLIP_RATE * delta.numel():
        raise AssertionError(f"{what}: more than last-bit flips (max|Δ| {float(delta.max())}, "
                             f"{n_flips} flips)")
    if blind is not None:
        blind_flips = int((blind.float() != ref).sum())
        if not blind_flips > FLIP_RATE * delta.numel():
            raise AssertionError(f"{what}: flip-rate gate blind to a bias added to the "
                                 f"unrounded product ({blind_flips} flips)")
    return n_flips, delta.numel(), float(delta.max())


def check_int4(torch, np, quant, flush) -> dict:
    """int4 at every product of the champion forward: the layer as the path
    launches it (int4_dense: bf16 out, bias fused where the layer has one)
    and the TPU kernel's f32 function (int4_matmul), each against its plain
    version, with rows bitwise independent of M. The JSON entry carries the
    layer; int4_matmul's numbers ride beside it under f32_out_*."""
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    totals = {kind: dict.fromkeys(keys, 0.0) for kind in ("layer", "f32")}
    max_err = {"layer": 0.0, "f32": 0.0}
    flips, elems, bound_by = 0, 0, set()
    layer_rows: dict[tuple[str, int], dict] = {}
    for name, k, n, count in INT4_SHAPES:
        packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8)).to(dev)
        scales = torch.from_numpy(
            (rng.uniform(0.5, 1.5, (k // 32, n)) / (7 * np.sqrt(k))).astype(np.float32)
        ).to(dev)
        has_bias = name not in NO_BIAS
        bias = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
                if has_bias else None)
        w_f32 = quant._unpack_int4_torch(packed, scales, 32)
        w_bf16 = w_f32.to(torch.bfloat16)

        x_all = torch.from_numpy(
            rng.standard_normal((max(int4_ms(name)), k)).astype(np.float32)).to(dev)
        x_all = x_all.to(torch.bfloat16)
        for what, fn in (("int4_matmul", lambda x: quant.int4_matmul(x, packed, scales)),
                         ("int4_dense", lambda x: quant.int4_dense(x, packed, scales, bias))):
            check_rows(torch, f"{what} {name}", fn, x_all, (1, *int4_ms(name)))
        for m in int4_ms(name):
            x = x_all[:m]
            out = quant.int4_matmul(x, packed, scales)
            ref = quant.int4_matmul_plain(x, packed, scales)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if not err <= INT4_TOL * scale:
                raise AssertionError(f"int4 {name} M={m}: max|Δ| {err} > {INT4_TOL} * {scale}")
            # the tolerance must catch a kernel that skips the bf16 rounding of W
            unrounded = float((torch.matmul(x.float(), w_f32) - ref).abs().max())
            if not unrounded > INT4_TOL * scale:
                raise AssertionError(f"int4 {name} M={m}: tolerance blind to unrounded W "
                                     f"({unrounded} <= {INT4_TOL} * {scale})")
            # the layer: its epilogue is bit-exact on the kernel's own product
            # (same body, same sum order), and held to the plain layer
            layer = quant.int4_dense(x, packed, scales, bias)
            own = out.to(torch.bfloat16) + (bias.to(torch.bfloat16) if has_bias else 0)
            if not torch.equal(bits(torch, layer), bits(torch, own.to(torch.bfloat16))):
                raise AssertionError(f"int4_dense {name} M={m}: the fused epilogue differs "
                                     f"from cast + bias add of the kernel's f32 product")
            ref_l = quant.int4_dense_plain(x, packed, scales, bias)
            blind = ((ref + bias.to(torch.bfloat16).float()).to(torch.bfloat16)
                     if has_bias else None)
            n_flips, n_el, err_l = check_layer(
                torch, f"int4_dense {name} M={m}", layer, ref_l,
                quant.int4_dense_plain(x, packed, scales), blind)
            flips, elems = flips + n_flips, elems + n_el
            max_err["f32"] = max(max_err["f32"], err)
            max_err["layer"] = max(max_err["layer"], err_l)

            lib = time_cuda(torch, lambda: torch.matmul(x, w_bf16), flush)
            timings = {
                "layer": (lambda: quant.int4_dense(x, packed, scales, bias),
                          lambda: quant.int4_dense_plain(x, packed, scales, bias), 2, has_bias),
                "f32": (lambda: quant.int4_matmul(x, packed, scales),
                        lambda: quant.int4_matmul_plain(x, packed, scales), 4, False),
            }
            line = []
            for kind, (kernel_fn, plain_fn, out_bytes, with_bias) in timings.items():
                ms = time_cuda(torch, kernel_fn, flush)
                plain = time_cuda(torch, plain_fn, flush)
                bound, by = int4_bound_ms(m, k, n, out_bytes, with_bias)
                line.append(f"{kind}: kernel {ms:.4f} plain {plain:.4f} bound {bound:.5f} ({by})")
                if kind == "layer":
                    layer_rows[(name, m)] = {"name": name, "m": m, "k": k, "n": n, "ms": ms,
                                             "plain_ms": plain, "library_ms": lib,
                                             "bound_ms": bound, "bound_by": by,
                                             "max_abs_err": err_l}
                if m == (2 * M_MAIN - 1 if name == "pos" else M_MAIN):
                    for key, v in zip(keys, (ms, plain, lib, bound)):
                        totals[kind][key] += count * v
                    if kind == "layer":
                        bound_by.add(by)
            print(f"  int4 {name:9s} M={m:4d} K={k:4d} N={n:4d}  f32 max|Δ|={err:.3g} "
                  f"(ref max {scale:.3g}, unrounded W {unrounded:.3g}); layer flips "
                  f"{n_flips}/{n_el} max|Δ|={err_l:.3g}  " + "; ".join(line)
                  + f"; torch.matmul(bf16 W) {lib:.4f} ms", flush=True)
    for kind, t in totals.items():
        print(f"  int4 ({kind}) per forward at M={M_MAIN} ({INT4_LAUNCHES_PER_FORWARD} launches): "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    print(f"  int4 (layer) last-bit flip rate {flips}/{elems} = {flips / elems:.3g}; rows "
          f"bitwise independent of M", flush=True)
    batched = []
    for t in BATCH_T:
        rows = [(count, layer_rows[(name, batched_m(name, t))])
                for name, _k, _n, count in INT4_SHAPES]
        per = {key: sum(c * r[key] for c, r in rows) for key in keys}
        batched.append({"b": BATCH, "t": t, "m": BATCH * t, **per})
        print(f"  int4 (layer) per batched forward B={BATCH} T={t} (M={BATCH * t}, "
              f"{INT4_LAUNCHES_PER_FORWARD} launches): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in per.items())
              + f"; kernel/library {per['ms'] / per['library_ms']:.3f}", flush=True)
    teacher = []
    ms_of = {name: distill_ms(name) for name, *_ in INT4_SHAPES}
    for j, m in enumerate(ms_of["proj"]):
        per = {key: sum(count * layer_rows[(name, ms_of[name][j])][key]
                        for name, _k, _n, count in INT4_SHAPES) for key in keys}
        teacher.append({"m": m, **per})
        print(f"  int4 (layer) per distillation teacher forward M={m} (pos M={ms_of['pos'][j]}, "
              f"{INT4_LAUNCHES_PER_FORWARD} launches): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in per.items()), flush=True)
    sweep = []
    for b, n, t in sweep_shapes():
        per = {key: sum(count * layer_rows[(name, sweep_m(name, b, t))][key]
                        for name, _k, _n, count in INT4_SHAPES) for key in keys}
        sweep.append({"b": b, "n": n, "t": t, "m": b * t, **per})
        print(f"  int4 (layer) per context-sweep forward B={b} N={n} (M={b * t}, pos M={2 * t - 1}, "
              f"{INT4_LAUNCHES_PER_FORWARD} launches): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in per.items()), flush=True)
    return {
        "name": "int4_matmul", "route": "cuda",
        "source": "tilawa_tpu_torch/csrc/quant_matmul.cuh",
        "replaces": "tilawa_tpu/ops/quant.py:131",
        "max_abs_err": max_err["layer"], **totals["layer"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "f32_out_max_abs_err": max_err["f32"],
        **{f"f32_out_{k}": v for k, v in totals["f32"].items()},
        "flip_rate": flips / elems,
        "batched_per_forward": batched, "teacher_per_forward": teacher,
        "sweep_per_forward": sweep,
        "shapes": list(layer_rows.values()),
    }


def check_int8(torch, np, quant, flush) -> dict:
    """Both orders of scaling at every product of the streaming and phoneme
    forwards (stream6-int8's 189 and phoneme-int8's (512, 70) head) at every
    M they launch, rows bitwise independent of M. The JSON entry carries
    Int8Dense's order with the bias fused where the layer has one (what the
    path launches), per stream6-int8 forward at M_MAIN; the _int8_kernel
    order's numbers ride beside it under scale_in_w_*, the phoneme head's
    per M under phoneme_head."""
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device(DEVICE)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    totals = {order: dict.fromkeys(keys, 0.0) for order in ("after", "in_w")}
    max_err = {"after": 0.0, "in_w": 0.0}
    flips, elems, bias_flips, bias_elems, bound_by = 0, 0, 0, 0, set()
    head: dict[int, dict] = {}
    for name, k, n, count in (*INT4_SHAPES, PHONEME_HEAD):
        q, scales = quant.quantize_int8(
            (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
        q, scales = torch.from_numpy(q).to(dev), torch.from_numpy(scales).to(dev)
        has_bias = name not in NO_BIAS
        bias = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
                if has_bias else None)
        w_f32 = q.float() * scales
        w_bf16 = w_f32.to(torch.bfloat16)

        x_all = torch.from_numpy(
            rng.standard_normal((max(int8_ms(name)), k)).astype(np.float32)).to(dev)
        x_all = x_all.to(torch.bfloat16)
        for what, fn in (("int8_matmul", lambda x: quant.int8_matmul(x, q, scales)),
                         ("int8_dense", lambda x: quant.int8_dense(x, q, scales, bias))):
            check_rows(torch, f"{what} {name}", fn, x_all, (1, *int8_ms(name)))
        for m in int8_ms(name):
            x = x_all[:m]
            # scale in W: f32 out, held like int4
            out = quant.int8_matmul(x, q, scales)
            ref = quant.int8_matmul_plain(x, q, scales)
            torch.cuda.synchronize()
            err_w = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if not err_w <= INT8_TOL * scale:
                raise AssertionError(f"int8 (scale in W) {name} M={m}: max|Δ| {err_w} > {INT8_TOL} * {scale}")
            unrounded = float((torch.matmul(x.float(), w_f32) - ref).abs().max())
            if not unrounded > INT8_TOL * scale:
                raise AssertionError(f"int8 {name} M={m}: tolerance blind to unrounded W "
                                     f"({unrounded} <= {INT8_TOL} * {scale})")
            # scale after, no bias: bf16 out, last-bit flips only
            out_d = quant.int8_dense(x, q, scales).float()
            ref_d = quant.int8_dense_plain(x, q, scales).float()
            torch.cuda.synchronize()
            delta = (out_d - ref_d).abs()
            scale_d = float(ref_d.abs().max())
            n_flips = int((delta > 0).sum())
            if not bool((delta <= INT8_ULP2 * ref_d.abs() + INT8_TOL * scale_d).all()) \
                    or n_flips > FLIP_RATE * delta.numel():
                raise AssertionError(f"int8 (scale after) {name} M={m}: more than last-bit "
                                     f"flips (max|Δ| {float(delta.max())}, {n_flips} flips)")
            # the flip-rate gate must catch a product left unrounded before the scale
            acc = torch.matmul(x.float(), q.float())
            s_bf16 = scales.to(torch.bfloat16).float()
            unrounded_flips = int(((acc * s_bf16).to(torch.bfloat16).float() != ref_d).sum())
            if not unrounded_flips > FLIP_RATE * delta.numel():
                raise AssertionError(f"int8 {name} M={m}: flip-rate gate blind to an unrounded "
                                     f"product ({unrounded_flips} flips)")
            # the layer with its bias fused
            ref_l = quant.int8_dense_plain(x, q, scales, bias)
            blind = (((acc.to(torch.bfloat16).float() * s_bf16) + bias.to(torch.bfloat16).float())
                     .to(torch.bfloat16) if has_bias else None)
            b_flips, b_el, err_l = check_layer(
                torch, f"int8_dense {name} M={m} (bias)",
                quant.int8_dense(x, q, scales, bias), ref_l, ref_d, blind)
            flips, elems = flips + n_flips, elems + delta.numel()
            bias_flips, bias_elems = bias_flips + b_flips, bias_elems + b_el
            max_err["in_w"] = max(max_err["in_w"], err_w)
            max_err["after"] = max(max_err["after"], float(delta.max()), err_l)

            timings = {
                "in_w": (lambda: quant.int8_matmul(x, q, scales),
                         lambda: quant.int8_matmul_plain(x, q, scales), 4, False),
                "after": (lambda: quant.int8_dense(x, q, scales, bias),
                          lambda: quant.int8_dense_plain(x, q, scales, bias), 2, has_bias),
            }
            lib = time_cuda(torch, lambda: torch.matmul(x, w_bf16), flush)
            line = []
            for order, (kernel_fn, plain_fn, out_bytes, with_bias) in timings.items():
                ms = time_cuda(torch, kernel_fn, flush)
                plain = time_cuda(torch, plain_fn, flush)
                bound, by = int8_bound_ms(m, k, n, out_bytes, with_bias)
                line.append(f"{order}: kernel {ms:.4f} plain {plain:.4f} bound {bound:.5f} ({by})")
                if name == PHONEME_HEAD[0] and order == "after":
                    head[m] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                               "bound_ms": bound, "bound_by": by}
                elif name != PHONEME_HEAD[0] and m == (2 * M_MAIN - 1 if name == "pos" else M_MAIN):
                    for key, v in zip(keys, (ms, plain, lib, bound)):
                        totals[order][key] += count * v
                    if order == "after":
                        bound_by.add(by)
            print(f"  int8 {name:9s} M={m:3d} K={k:4d} N={n:4d}  scale-in-W max|Δ|={err_w:.3g} "
                  f"(ref max {scale:.3g}, unrounded W {unrounded:.3g}); scale-after flips "
                  f"{n_flips}/{delta.numel()} max|Δ|={float(delta.max()):.3g} (unrounded product "
                  f"{unrounded_flips}), with bias {b_flips} flips max|Δ|={err_l:.3g}  "
                  + "; ".join(line) + f"; torch.matmul(bf16 W) {lib:.4f} ms", flush=True)
    for order, t in totals.items():
        print(f"  int8 ({order}) per forward at M={M_MAIN} ({INT8_LAUNCHES_PER_FORWARD} launches): "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    print(f"  int8 (after) last-bit flip rate {flips}/{elems} = {flips / elems:.3g}, with bias "
          f"{bias_flips}/{bias_elems} = {bias_flips / bias_elems:.3g}; rows bitwise "
          f"independent of M", flush=True)
    return {
        "name": "int8_matmul", "route": "cuda",
        "source": "tilawa_tpu_torch/csrc/quant_matmul.cuh",
        "replaces": "tilawa_tpu/ops/quant.py:150",
        "max_abs_err": max_err["after"], **totals["after"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "scale_in_w_max_abs_err": max_err["in_w"],
        **{f"scale_in_w_{k}": v for k, v in totals["in_w"].items()},
        "flip_rate": flips / elems, "flip_rate_with_bias": bias_flips / bias_elems,
        "phoneme_head": {str(m): v for m, v in head.items()},
    }


def lattice_case(torch, np, t: int, v: int, c: int, l_pad: int, lengths, seed: int) -> tuple:
    """Log-probs [T, V] (log-softmax of N(0, 2²) logits) and c zero-padded
    candidates of the given live lengths (never the blank V-1; every third
    with a run of one token), the rest padding, on the card."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, v)).astype(np.float32) * 2
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    tokens = np.zeros((c, l_pad), np.int32)
    lens = np.zeros(c, np.int32)
    for i, n in enumerate(lengths):
        ids = rng.integers(0, v - 1, size=n)
        if i % 3 == 0 and n > 4:
            ids[1:4] = ids[0]
        tokens[i, :n], lens[i] = ids, n
    return tuple(torch.from_numpy(a).to(DEVICE) for a in (lp, tokens, lens))


def lattice_gate(torch, what: str, out, ref) -> float:
    """The lattice's scores (one row a call: [C], or [B, C]) against the
    plain version's: equal +inf patterns, finite scores within LATTICE_TOL
    (rtol and atol), equal argmin a row. Returns the largest finite |Δ|."""
    out, ref = torch.as_tensor(out).double(), torch.as_tensor(ref).double()
    inf = torch.isinf(ref)
    if out.shape != ref.shape or not torch.equal(torch.isinf(out), inf):
        raise AssertionError(f"{what}: +inf patterns differ from the plain version's")
    fin = ~inf
    delta = (out[fin] - ref[fin]).abs()
    if not bool((delta <= LATTICE_TOL + LATTICE_TOL * ref[fin].abs()).all()):
        raise AssertionError(f"{what}: max|Δ| {float(delta.max())} beyond {LATTICE_TOL}")
    if not torch.equal(out.argmin(-1), ref.argmin(-1)):
        raise AssertionError(f"{what}: the best candidate differs from the plain version's")
    return float(delta.max()) if delta.numel() else 0.0


def lattice_bound_ms(np, t_valids, t: int, v: int, tokens, lens, base: int,
                     row_bytes: int) -> tuple[float, str, int]:
    """What the lattice function needs for rows of these t_valid against
    these candidates, over the log-probs at address `base` (row b at base +
    b * row_bytes, frame t a further t * 4 V bytes). Bytes (over
    HBM_BYTES_S): in each row's t_valid frames only the blank column and the
    token columns of the row's feasible candidates are read, so a frame
    counts 32 bytes for each distinct 32-byte sector that holds one of them,
    at most its 4 V bytes; plus the tokens, lengths and t_valids read once
    and the scores written once. Work (over MUFU_OPS_S): per live frame
    t >= 1 of a feasible candidate of length L, 2 expf + 2 log1pf a label
    state and 1 + 1 a blank state, 6 L + 2 transcendentals. Returns (ms,
    what binds, transcendentals)."""
    tokens = np.asarray(tokens)
    lens = [int(n) for n in lens]
    nbytes = len(lens) * (tokens.shape[1] + 1) * 4 + len(t_valids) * (len(lens) + 1) * 4
    ops = 0
    for b, tv in enumerate(t_valids):
        live = [c for c, n in enumerate(lens) if n > 0 and 2 * n + 1 <= tv]
        if not live:
            continue
        cols = np.unique(np.concatenate([tokens[c, :lens[c]] for c in live] + [[v - 1]]))
        frames = np.arange(min(tv, t), dtype=np.int64)
        sectors = np.sort((base + b * row_bytes + frames[:, None] * (4 * v)
                           + cols[None, :].astype(np.int64) * 4) // 32, axis=1)
        per_frame = 1 + (np.diff(sectors, axis=1) != 0).sum(axis=1)
        nbytes += int(np.minimum(32 * per_frame, 4 * v).sum())
        ops += sum((min(tv, t) - 1) * (6 * lens[c] + 2) for c in live)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / MUFU_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), ops


def lattice_log1p_mismatches(torch, kernels) -> int:
    """Floats, of all 2^32, where the lattice kernel's branch-free log1pf
    differs in any bit from CUDA's log1pf (one launch of the library's
    checker, not a lattice launch)."""
    import ctypes

    fn = kernels.function("ctc_lattice", "tilawa_ctc_lattice_check_log1p",
                          [ctypes.c_void_p, ctypes.c_void_p])
    bad = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    kernels.check(fn(bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
                  "lattice log1p check")
    return int(bad.item())


def lattice_chain_us(entry: dict) -> float:
    """The lattice's us a frame at its "chain floor" shape (one candidate of
    one token) in this run: the card's floor for one dependent frame."""
    return next(r["us_per_frame"] for r in entry["shapes"] if r["label"] == "chain floor")


def check_lattice(torch, np, ctc, flush) -> dict:
    """The CTC lattice kernel at every LATTICE_CASES shape and the batch
    form at B = 4 with four t_valid, against its plain version (lattice_gate),
    feasible rows exactly the finite ones; the kernel's time, the plain
    version's, the bound and one library yardstick: F.ctc_loss(reduction=
    "none") over the same log-probs expanded to [T, C, V], the reference's
    own formulation (its feasibility rule differs, so its |Δ| against the
    kernel is printed on the feasible rows only). The JSON entry carries the
    champion's rerank chunk, every shape under `shapes`."""
    import torch.nn.functional as F

    from tilawa_tpu_torch.ops import kernels

    mismatches = lattice_log1p_mismatches(torch, kernels)
    print(f"  lattice log1pf_flat against CUDA's log1pf: {mismatches} of 2^32 floats differ",
          flush=True)
    if mismatches:
        raise AssertionError("the lattice's log1pf is not CUDA's")
    rows = {}

    def library_fn(lp_tcv, tokens, input_lengths, lens):
        targets = tokens.long()
        target_lengths = lens.tolist()
        return lambda: F.ctc_loss(lp_tcv, targets, input_lengths, target_lengths,
                                  blank=lp_tcv.shape[-1] - 1, reduction="none")

    def measure(label, t, v, c, l_pad, t_valids, lp, tokens, lens, kernel, plain, library,
                out, ref):
        err = lattice_gate(torch, f"lattice {label}", out, ref)
        feasible = (2 * lens + 1 <= torch.tensor(t_valids, device=DEVICE)[:, None]) & (lens > 0)
        if not torch.equal(torch.isfinite(out.reshape(len(t_valids), c)), feasible):
            raise AssertionError(f"lattice {label}: finite scores are not the feasible rows")
        slow = t * l_pad > 4 << 20          # the phoneme shape: the plain loop takes seconds
        plan = ctc.lattice_plan(l_pad, c, len(t_valids),
                                t_valid=t_valids[0] if len(t_valids) == 1 else None)
        frames = min(max(t_valids), t) - 1
        ms = time_cuda(torch, kernel, flush)
        plain_ms = time_cuda(torch, plain, flush, reps=1 if slow else 3, warmup=0 if slow else 1)
        lib = library()
        lib_err = float(((lib.reshape(len(t_valids), c) / lens.clamp(min=1)) - out.reshape(
            len(t_valids), c)).abs()[feasible].max()) if bool(feasible.any()) else 0.0
        lib_ms = time_cuda(torch, library, flush, reps=3 if slow else 20, warmup=1 if slow else 3)
        bound, by, ops = lattice_bound_ms(np, t_valids, t, v, tokens.cpu().numpy(), lens.tolist(),
                                          lp.data_ptr(), lp.stride(0) * 4 if lp.dim() == 3 else 0)
        us_frame = ms * 1e3 / frames if frames > 0 else None
        print(f"  lattice {label:15s} T={t} V={v} C={c} L_pad={l_pad} t_valid={list(t_valids)} "
              f"(the serial chain, frames) live {int((lens > 0).sum())}, feasible "
              f"{int(feasible.sum())}; {plan.describe()}: max|Δ|={err:.3g}  kernel {ms:.4f} ms "
              f"({'-' if us_frame is None else f'{us_frame:.4f}'} us a frame)  plain "
              f"{plain_ms:.4f} ms  F.ctc_loss {lib_ms:.4f} ms (|Δ| on feasible rows "
              f"{lib_err:.3g})  bound {bound:.5f} ms ({by}; {ops} transcendentals at "
              f"{MUFU_OPS_S:.4g}/s)", flush=True)
        rows[label] = {"label": label, "t": t, "v": v, "c": c, "l_pad": l_pad,
                       "t_valid": list(t_valids), "feasible": int(feasible.sum()),
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "library_abs_err": lib_err, "bound_ms": bound, "bound_by": by,
                       "transcendentals": ops, "variant": plan.variant,
                       "plan": dataclasses.asdict(plan), "us_per_frame": us_frame}

    for i, (label, t, v, c, l_pad, t_valid, lengths) in enumerate(LATTICE_CASES):
        lp, tokens, lens = lattice_case(torch, np, t, v, c, l_pad, lengths, SEED + 10 + i)
        blank = v - 1
        out = ctc.ctc_forward_scores(lp, t_valid, tokens, lens, blank)
        ref = ctc.ctc_forward_scores_plain(lp, t_valid, tokens, lens, blank)
        torch.cuda.synchronize()
        measure(label, t, v, c, l_pad, (t_valid,), lp, tokens, lens,
                lambda: ctc.ctc_forward_scores(lp, t_valid, tokens, lens, blank),
                lambda: ctc.ctc_forward_scores_plain(lp, t_valid, tokens, lens, blank),
                library_fn(lp[:, None, :].expand(t, c, v), tokens, [t_valid] * c, lens), out, ref)
        del lp, ref

    lp, tokens, lens = lattice_case(torch, np, 512, 1025, 64, 128, (128, 90, 33, 6, 1), SEED + 9)
    rows4 = torch.stack([lp, lp.flip(0), lp.roll(7, 0), lp * 1.5]).log_softmax(-1)
    t_valid = torch.tensor(LATTICE_BATCH_T_VALID, dtype=torch.int32, device=DEVICE)
    out = ctc.ctc_forward_scores_batch(rows4, t_valid, tokens, lens, 1024)
    ref = ctc.ctc_forward_scores_batch_plain(rows4, t_valid, tokens, lens, 1024)
    for b, tv in enumerate(LATTICE_BATCH_T_VALID):
        if not torch.equal(bits(torch, out[b]),
                           bits(torch, ctc.ctc_forward_scores(rows4[b], tv, tokens, lens, 1024))):
            raise AssertionError(f"lattice batch: row {b} differs from the single form")
    expanded = rows4.transpose(0, 1)[:, :, None, :].expand(512, 4, 64, 1025).reshape(512, 256, 1025)
    measure("batch B=4", 512, 1025, 64, 128, LATTICE_BATCH_T_VALID, rows4, tokens, lens,
            lambda: ctc.ctc_forward_scores_batch(rows4, t_valid, tokens, lens, 1024),
            lambda: ctc.ctc_forward_scores_batch_plain(rows4, t_valid, tokens, lens, 1024),
            library_fn(expanded, tokens.repeat(4, 1),
                       [tv for tv in LATTICE_BATCH_T_VALID for _ in range(64)], lens.repeat(4)),
            out, ref)
    print("  lattice batch: each row bitwise the single form at its t_valid", flush=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return {
        "name": "ctc_lattice", "route": "cuda",
        "source": "tilawa_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "tilawa_tpu/ops/ctc.py:53",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        **{k: rows["rerank chunk"][k] for k in keys},
        "t_valid": rows["rerank chunk"]["t_valid"][0],
        "variants": {label: r["variant"] for label, r in rows.items()},
        "shapes": list(rows.values()),
    }


def ctc_loss_case(torch, np, b: int, t: int, v: int, l_pad: int, l_max: int, seed: int,
                  device=DEVICE) -> tuple:
    """A training loss's inputs on the card: x = log_softmax of N(0, 2²)
    logits [B, T, V] f32 (a head's output); row r's labels l_max - r·l_max
    // 2B tokens long (at least 1; never the blank V-1; every other row
    with a run of one token), zero-padded to l_pad; enc_len T - r·T // 3B,
    but with B >= 2 the last row 2 frames short of its labels (infeasible:
    optax's finite loss). Returns (x, enc_len, tokens, token_lens) int32 on
    the card and the blank."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 2
    tokens = np.zeros((b, l_pad), np.int32)
    lens = np.zeros(b, np.int32)
    enc = np.zeros(b, np.int32)
    for r in range(b):
        n = max(1, l_max - r * l_max // (2 * b))
        ids = rng.integers(0, v - 1, size=n)
        if r % 2 == 0 and n > 4:
            ids[1:4] = ids[0]
        tokens[r, :n], lens[r] = ids, n
        need = n + int(np.sum(ids[1:] == ids[:-1]))
        enc[r] = max(1, need - 2) if b >= 2 and r == b - 1 else t - r * t // (3 * b)
    x = torch.from_numpy(logits).to(device).log_softmax(-1)
    return (x, *(torch.from_numpy(a).to(device) for a in (enc, tokens, lens)), v - 1)


def ctc_loss_gate(torch, what: str, loss, grad, ref_loss, ref_grad) -> tuple[float, float]:
    """The loss kernels' rows and gradient against the plain version's:
    finite losses, each row's loss within CTC_LOSS_TOL (relative), each
    row's max|Δ gradient| within CTC_GRAD_TOL of its plain max|g| (0 where
    that is 0). Returns the worst loss and gradient ratios."""
    loss, ref_loss = loss.double(), ref_loss.double()
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"{what}: a loss is not finite")
    rel = float(((loss - ref_loss).abs() / ref_loss.abs()).max())
    b = grad.shape[0]
    top = ref_grad.reshape(b, -1).abs().amax(1).double()
    err = (grad - ref_grad).reshape(b, -1).abs().amax(1).double()
    # a row with no live frame has no gradient: there any difference fails
    ratio = float(torch.where(top > 0, err / top.clamp(min=1e-300),
                              torch.where(err > 0, torch.inf, 0.0)).max())
    if not (rel <= CTC_LOSS_TOL and ratio <= CTC_GRAD_TOL):
        raise AssertionError(f"{what}: loss rel {rel:.3g} (bound {CTC_LOSS_TOL}), gradient "
                             f"max|Δ|/max|g| {ratio:.3g} (bound {CTC_GRAD_TOL})")
    return rel, ratio


def ctc_loss_bound_ms(b: int, t: int, v: int, enc, lens) -> tuple[float, str, int]:
    """What a forward and backward of the loss need for these rows. Bytes
    (over HBM_BYTES_S): x's live frames read by each (forward and backward
    are two calls), the gradient [B, T, V] written once, lengths and tokens
    negligible. Work (over MUFU_OPS_S): per live frame V + 1 (the
    normalizer's exps and log) and V (the gradient's softmax); per live
    frame and label (L a row) the recursion's 3 logaddexps (emit, pp and
    phi), an expf and a log1pf each forward and two weight exps each
    back, 12 transcendentals (what the function needs: the kernel's
    recomputation of pp in the backward is not counted). Returns (ms,
    what binds, transcendentals)."""
    live = [min(max(int(e), 0), t) for e in enc]
    frames = sum(live)
    nbytes = 2 * frames * v * 4 + b * t * v * 4
    ops = frames * (2 * v + 1) + sum(tr * max(int(n), 0) * 12 for tr, n in zip(live, lens))
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / MUFU_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), ops


def ctc_loss_kernel(ctc, x, enc, tokens, lens, blank, weight, plan=None):
    """The loss kernels' two launches, forward and backward (upstream
    `weight` a row), laid out by `plan` (ops/ctc.py loss_plan's by
    default): (loss, gradient)."""
    if plan is None:    # a checkout whose launcher takes no plan (--lattice-times)
        loss, work = ctc._loss_forward_kernel(x, enc, tokens, lens, blank)
    else:
        loss, work = ctc._loss_forward_kernel(x, enc, tokens, lens, blank, plan)
    return loss, ctc._loss_backward_kernel(x, enc, tokens, lens, blank, weight, *work)


def check_ctc_loss(torch, np, ctc, flush, chain_us: float) -> dict:
    """The training loss's kernels at every CTC_LOSS_CASES shape: loss and
    gradient (upstream 1/B a row, the mean) through ops/ctc.py ctc_loss
    against ctc_loss_plain and ctc_loss_grad_plain (the loss bitwise, the
    gradient by ctc_loss_gate), two kernel runs bitwise equal; forward plus
    backward timed for the kernels (their two launches), the plain versions
    and F.ctc_loss (reduction "none", its backward; the library's
    yardstick, inf on the infeasible row, zeroed); the bound and, beside
    it, the chain floor: twice (forward and backward) the row's frames at
    `chain_us` a frame, the lattice's own one-token chain in this run; the
    layout each shape took (ops/ctc.py loss_plan). The JSON entry carries
    the 8 s text bucket, every shape under `shapes`."""
    import torch.nn.functional as F

    rows = {}
    for i, (label, b, t, v, l_pad, l_max) in enumerate(CTC_LOSS_CASES):
        x, enc, tokens, lens, blank = ctc_loss_case(torch, np, b, t, v, l_pad, l_max,
                                                    SEED + 40 + i)
        weight = torch.full((b,), 1.0 / b, device=DEVICE)
        plan = ctc.loss_plan(l_pad, b)

        def kernel():
            return ctc_loss_kernel(ctc, x, enc, tokens, lens, blank, weight, plan)

        def plain():
            return (ctc.ctc_loss_plain(x, enc, tokens, lens, blank),
                    ctc.ctc_loss_grad_plain(x, enc, tokens, lens, blank, weight))

        xg = x.detach().requires_grad_()
        loss = ctc.ctc_loss(xg, enc, tokens, lens, blank)
        (grad,) = torch.autograd.grad(loss, xg, weight)
        loss = loss.detach()
        again = kernel()
        ref_loss, ref_grad = plain()
        torch.cuda.synchronize()
        rel, ratio = ctc_loss_gate(torch, f"ctc loss {label}", loss, grad, ref_loss, ref_grad)
        if not torch.equal(bits(torch, loss), bits(torch, ref_loss)):
            raise AssertionError(f"ctc loss {label}: the loss is not bitwise the plain one")
        if not (torch.equal(bits(torch, loss), bits(torch, again[0]))
                and torch.equal(bits(torch, grad), bits(torch, again[1]))):
            raise AssertionError(f"ctc loss {label}: two kernel runs differ")
        err = float((grad - ref_grad).abs().max())
        lib_x = x.detach().requires_grad_()
        targets, in_lens, tgt_lens = tokens.long(), enc.long(), lens.long()

        def library():
            out = F.ctc_loss(lib_x.transpose(0, 1), targets, in_lens, tgt_lens, blank=blank,
                             reduction="none", zero_infinity=True)
            out.backward(weight)

        ms = time_cuda(torch, kernel, flush)
        slow = t * b > 2000
        plain_ms = time_cuda(torch, plain, flush, reps=1 if slow else 3, warmup=0 if slow else 1)
        lib_ms = time_cuda(torch, library, flush)
        bound, by, ops = ctc_loss_bound_ms(b, t, v, enc.tolist(), lens.tolist())
        t_max = int(enc.clamp(max=t).max())
        floor_ms = 2 * t_max * chain_us / 1e3
        need = [int(n) + int((r[1:n] == r[:n - 1]).sum())
                for r, n in zip(tokens.cpu().numpy(), lens.tolist())]
        infeasible = sum(nd > e for nd, e in zip(need, enc.tolist()))
        print(f"  ctc loss {label:18s} B={b} T={t} V={v} L_pad={l_pad} L_max={l_max} "
              f"({infeasible} infeasible row(s); {plan.describe()}): loss bitwise the plain "
              f"one, max|Δg|/max|g| {ratio:.3g}, bitwise run to run; "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  F.ctc_loss {lib_ms:.4f} ms  "
              f"bound {bound:.5f} ms ({by}; {ops} transcendentals)  chain floor "
              f"{floor_ms:.4f} ms (2 x {t_max} frames x {chain_us:.4f} us; kernel "
              f"{ms / floor_ms:.2f}x)", flush=True)
        rows[label] = {"label": label, "b": b, "t": t, "v": v, "l_pad": l_pad, "l_max": l_max,
                       "infeasible_rows": infeasible, "variant": plan.variant,
                       "plan": dataclasses.asdict(plan),
                       "loss_rel_err": rel, "grad_ratio": ratio, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "bound_by": by, "transcendentals": ops,
                       "chain_floor_ms": floor_ms}
        del x, xg, grad, ref_grad, again, lib_x
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "chain_floor_ms")
    head = rows[CTC_LOSS_CASES[0][0]]
    return {
        "name": "ctc_loss", "route": "cuda", "source": "tilawa_tpu_torch/csrc/ctc_loss.cu",
        "replaces": "tilawa_tpu/train/train.py:53",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "loss_rel_err": max(r["loss_rel_err"] for r in rows.values()),
        "grad_ratio": max(r["grad_ratio"] for r in rows.values()),
        **{k: head[k] for k in keys}, "shape": CTC_LOSS_CASES[0][0],
        "variants": {label: r["variant"] for label, r in rows.items()},
        "shapes": list(rows.values()),
    }


def preemphasize(torch, frontend, audio):
    return torch.cat([audio[:, :1], audio[:, 1:] - frontend.PREEMPH * audio[:, :-1]], dim=1)


def check_mel_invariance(torch, np, frontend, tables) -> None:
    """A frame's log-mels are bitwise a function of its 400 samples: each
    row of a B=3 batch equals the row launched alone, and the frames of
    pre[:, 160 j:] equal frames j.. of pre (offsets that move a frame to
    every place in a block; T = 398 is not a multiple of the block's
    frames, so the batch rows start at other places too)."""
    rng = np.random.default_rng(SEED + 2)
    audio = torch.from_numpy((rng.standard_normal((3, 64000)) * 0.1).astype(np.float32))
    pre = preemphasize(torch, frontend, audio.to(DEVICE))
    full = bits(torch, frontend.fused_log_mel(pre, tables))
    for b in range(3):
        alone = frontend.fused_log_mel(pre[b:b + 1].contiguous(), tables)
        if not torch.equal(bits(torch, alone), full[b:b + 1]):
            raise AssertionError(f"log-mel: row {b} of B=3 differs from the row alone")
    for j in MEL_OFFSETS:
        shifted = frontend.fused_log_mel(pre[:, 160 * j:].contiguous(), tables)
        if not torch.equal(bits(torch, shifted), full[:, j:]):
            raise AssertionError(f"log-mel: frames of pre[:, {160 * j}:] differ from "
                                 f"frames {j}.. of pre")
    print(f"  log-mel rows of B=3 equal each row alone, frames at offsets {MEL_OFFSETS} "
          f"equal the unshifted frames: bitwise", flush=True)


def check_log_mel(torch, np, frontend, flush) -> dict:
    """The log-mel kernel at every (B, N) the paths launch, against its
    plain version (cuFFT rfft) and one library yardstick (torch.stft +
    matmul), plus its bitwise invariances. The JSON entry carries B=2,
    N=64000 (as in earlier runs), the B=1 forward bucket beside it under
    b1_*, and every shape under `shapes`."""
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device(DEVICE)
    tables = frontend.mel_tables(dev)
    window = tables.window
    fb_nonzeros = int((tables.fb != 0).sum())
    rows = {}
    for b, n in mel_shapes():
        audio = torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32)).to(dev)
        pre = preemphasize(torch, frontend, audio)
        out = frontend.fused_log_mel(pre, tables)
        ref = frontend.log_mel_plain(pre, tables)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= MEL_TOL:
            raise AssertionError(f"log-mel B={b} N={n}: max|Δ| {err} > {MEL_TOL}")
        if b == BATCH:
            alone = frontend.fused_log_mel(pre[b - 3:b - 2].contiguous(), tables)
            if not torch.equal(bits(torch, alone), bits(torch, out[b - 3:b - 2])):
                raise AssertionError(f"log-mel B={b} N={n}: row {b - 3} differs from the row alone")

        def library():
            # stft centres the 400-sample window in each 512-point frame; a
            # 56-sample pad on both sides makes its frames ours (the power
            # spectrum does not see the circular shift)
            padded = torch.nn.functional.pad(pre, (56, 56))
            spec = torch.stft(padded, n_fft=512, hop_length=160, win_length=400,
                              window=window, center=False, return_complex=True)
            power = spec.real ** 2 + spec.imag ** 2                     # [B, 257, T]
            return torch.log(torch.matmul(power.transpose(1, 2), tables.fb) + 1e-5)

        lib_err = float((library() - ref).abs().max())
        ms = time_cuda(torch, lambda: frontend.fused_log_mel(pre, tables), flush)
        plain = time_cuda(torch, lambda: frontend.log_mel_plain(pre, tables), flush)
        lib = time_cuda(torch, library, flush)
        bound, by = mel_bound_ms(b, n, out.shape[1], fb_nonzeros)
        print(f"  log-mel B={b} N={n} T={out.shape[1]}  max|Δ|={err:.3g} (stft yardstick "
              f"{lib_err:.3g})  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
              f"stft+matmul {lib:.4f} ms (kernel/library {ms / lib:.3f})  "
              f"bound {bound:.5f} ms ({by})", flush=True)
        rows[(b, n)] = {"b": b, "n": n, "t": out.shape[1], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "library_ms": lib, "bound_ms": bound, "bound_by": by}
    check_mel_invariance(torch, np, frontend, tables)
    tiny = torch.empty(1, device=dev)
    floor = time_cuda(torch, lambda: tiny.fill_(0.0), flush)
    print(f"  launch floor of these events (a one-element fill): {floor:.4f} ms", flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": "log_mel", "route": "cuda",
        "source": "tilawa_tpu_torch/csrc/log_mel.cu",
        "replaces": "tilawa_tpu/ops/frontend.py:134",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        **{k: rows[(2, 64000)][k] for k in keys},
        **{f"b1_{k}": rows[(1, 64000)][k] for k in keys},
        "shapes": list(rows.values()), "launch_floor_ms": floor,
        "sweep_shapes": [rows[(b, n)] for b, n, _t in sweep_shapes()],
    }


def _pcts(values: list[float]) -> str:
    if not values:
        return "-"
    v = sorted(values)
    return f"{v[len(v) // 2] * 1e3:.2f}/{v[int(0.9 * (len(v) - 1))] * 1e3:.2f}"


def streaming(torch, kernels, rerank, validate_streaming, recognizer) -> tuple[dict, dict]:
    """Replay STREAM_IDS through the port's validate_streaming harness, one
    clip at a time, timing each cycle's forward (the runtime's forward ends
    in a host read of the ids) and each call of the tracker's CTC fusion
    scorer (one lattice launch a scorer chunk; its calls replayed on the
    plain version by lattice_report). Returns the launch counts of the
    replay and lattice_report's numbers."""
    runtime = recognizer.runtime
    forward_s: list[float] = []
    scoring_s: list[float] = []

    def transcribe(audio):
        return recognizer.transcribe_result(audio)

    db, store = recognizer.db, recognizer.token_store
    wrong = []
    with timed_calls(runtime, "forward", forward_s), \
            timed_calls(rerank, "score_token_lists", scoring_s), \
            lattice_record(torch, rerank) as lattice:
        torch.cuda.synchronize()
        kernels.reset_launches()
        runtime.forwards = 0
        for clip_id in STREAM_IDS:
            forward_s.clear()
            scoring_s.clear()
            res = validate_streaming.run_validation(
                transcribe, ids={clip_id}, db=db, token_store=store, verbose=False)
            row = res["per_sample"][0]
            got = [(e["surah"], e["ayah"]) for e in row["predicted"]]
            print(f"  {clip_id:18s} seq_acc {row['sequence_accuracy']:.2f} got {got}  "
                  f"wall {row['latency'] * 1e3:.1f} ms  cycles {len(forward_s)}  "
                  f"p50/p90 ms: forward {_pcts(forward_s)}, fusion scoring {_pcts(scoring_s)} "
                  f"({len(scoring_s)} calls), feed {res['cycle_p50'] * 1e3:.1f}/"
                  f"{res['cycle_p90'] * 1e3:.1f}, decode feed {res['decode_cycle_p50'] * 1e3:.1f}/"
                  f"{res['decode_cycle_p90'] * 1e3:.1f}", flush=True)
            if row["sequence_accuracy"] != 1.0 or res["total"] != 1:
                wrong.append(clip_id)
        torch.cuda.synchronize()
        launches, forwards = dict(kernels.LAUNCHES), runtime.forwards
    print(f"  replay: {forwards} forwards; launches {launches}", flush=True)
    if wrong:
        raise AssertionError(f"streaming clips below sequence accuracy 1.0: {wrong}")
    if forwards == 0 or launches["int8_matmul"] != INT8_LAUNCHES_PER_FORWARD * forwards \
            or launches["log_mel"] != forwards or launches["int4_matmul"] != 0:
        raise AssertionError("the streaming path did not run the int8 and log-mel kernels "
                             "once per layer and forward")
    check_lattice_launches("streaming replay", launches, lattice)
    return launches, lattice_report(torch, rerank, "streaming replay (fusion scoring)", lattice,
                                    len(STREAM_IDS))


def batch_variance(torch, np, runtime, frontend, audio, rows: int = 2,
                   n: int | None = None) -> dict[str, float]:
    """Which ops of the forward give row 0 another value at batch `rows`
    than at batch 1, each on the same input. `rows` windows of `audio`, n
    samples long (default LONG_CHUNK, 16 s; for 2 rows, the first two, as
    forward_long and the cache forward them; for more, at evenly spaced
    starts), go through the model as one [rows, n] batch, with every
    module's inputs and output kept;
    then each module runs again on row 0 of its own inputs alone. A module
    whose row 0 differs while none of its submodules' does holds the op in
    its own code. The frontend (outside any module) is checked the same way,
    the log-mel kernel alone and with the normalization. Prints and returns
    {module: max |Δ|} of those origins."""
    from tilawa_tpu_torch.pipeline.runtime import LONG_CHUNK, LONG_STEP

    model = runtime.model
    n = LONG_CHUNK if n is None else n
    step = LONG_STEP if n == LONG_CHUNK else max(len(audio) - n, 0)
    starts = [round(i * step / (rows - 1)) for i in range(rows)]
    pieces = [audio[s:s + n] for s in starts]
    kept: list = []

    def hook(name):
        def fn(module, args, out):
            out = out[0] if isinstance(out, tuple) else out
            kept.append((name, module, [a.clone() if torch.is_tensor(a) else a for a in args],
                         out.clone()))
        return fn

    def row0(a):
        return a[:1] if torch.is_tensor(a) and a.dim() and a.shape[0] == rows else a

    def differs(a, b) -> float:
        if torch.equal(bits(torch, a), bits(torch, b)):
            return 0.0
        return max(float((a.float() - b.float()).abs().max()), float("1e-45"))

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules() if name]
    try:
        runtime._apply_upload(pieces, n, rows)
    finally:
        for h in handles:
            h.remove()
    deltas = {}
    with torch.inference_mode():
        batch = np.zeros((rows, n), np.int16)
        for i, piece in enumerate(pieces):
            batch[i, : len(piece)] = np.clip(piece * 32768.0, -32768, 32767)
        audio_t = torch.from_numpy(batch).to(DEVICE).float() / 32768.0
        lengths = torch.tensor([len(piece) for piece in pieces], dtype=torch.int32,
                               device=DEVICE)
        tables = model.tables()
        pre = preemphasize(torch, frontend, audio_t)
        deltas["(log-mel kernel)"] = differs(frontend.fused_log_mel(pre, tables)[:1],
                                             frontend.fused_log_mel(pre[:1], tables))
        feats2, _ = frontend.log_mel_spectrogram(audio_t, lengths, tables)
        feats1, _ = frontend.log_mel_spectrogram(audio_t[:1], lengths[:1], tables)
        deltas["(frontend: log-mel + normalization)"] = differs(feats2[:1], feats1)
        for name, module, args, out in kept:
            if out.dim() and out.shape[0] == rows:
                one = module(*(row0(a) for a in args))
                one = one[0] if isinstance(one, tuple) else one
                deltas[name] = differs(out[:1], one)
    varying = {n: d for n, d in deltas.items() if d > 0}
    origins = {n: d for n, d in varying.items()
               if not any(o.startswith(n + ".") for o in varying)}
    kinds: dict[str, list] = {}
    for name, d in origins.items():
        kind = type(model.get_submodule(name)).__name__ if not name.startswith("(") else name
        kinds.setdefault(kind, []).append((name, d))
    for kind, names in kinds.items():
        worst = max(names, key=lambda r: r[1])
        print(f"    batch {rows} vs 1 at equal input, row 0 differs in {len(names)} {kind} "
              f"(own code; e.g. {names[0][0]}; max|Δ| {worst[1]:.3g} in {worst[0]})", flush=True)
    print(f"    {len(origins)} origins, {len(varying)} of {len(deltas)} modules vary with the "
          f"batch size", flush=True)
    return origins


def bucket_variance(torch, runtime, piece, n_own: int, n_pad: int) -> dict[str, float]:
    """Which modules give a clip's valid frames other values when it is
    padded to the bucket n_pad than at n_own (the same samples): the
    forward runs at each bucket with every module's inputs and output kept;
    a module whose output's valid frames ([B, T, ...] tensors, the first
    t_valid of T encoder frames) differ while its inputs' valid frames are
    equal (inputs without that axis, such as the relative positions, are
    not compared) is an origin. Prints and returns {module: max |Δ|}."""
    from tilawa_tpu_torch.train.train import encoder_lengths

    model = runtime.model
    t_valid = int(encoder_lengths([len(piece)])[0])
    runs = []
    for n in (n_own, n_pad):
        kept: dict = {}

        def hook(name):
            def fn(module, args, out):
                out = out[0] if isinstance(out, tuple) else out
                kept.setdefault(name, ([a.clone() for a in args if torch.is_tensor(a)],
                                       out.clone() if torch.is_tensor(out) else None))
            return fn

        handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()
                   if name]
        try:
            runtime._apply_upload([piece], n, 1)
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        runs.append((kept, int(encoder_lengths([n])[0])))

    def valid(a, frames):
        return a[:, :t_valid] if a is not None and a.dim() >= 2 and a.shape[1] == frames else None

    def differs(a, b) -> float:
        if torch.equal(bits(torch, a), bits(torch, b)):
            return 0.0
        return max(float((a.float() - b.float()).abs().max()), float("1e-45"))

    (own, t_own), (pad, t_pad) = runs
    origins = {}
    for name, (args_o, out_o) in own.items():
        args_p, out_p = pad[name]
        vo, vp = valid(out_o, t_own), valid(out_p, t_pad)
        if vo is None or vp is None or not differs(vo, vp):
            continue
        ins = [(valid(a, t_own), valid(b, t_pad)) for a, b in zip(args_o, args_p)]
        if all(differs(a, b) == 0.0 for a, b in ins if a is not None and b is not None):
            origins[name] = differs(vo, vp)
    kinds: dict[str, list] = {}
    for name, d in origins.items():
        kinds.setdefault(type(model.get_submodule(name)).__name__, []).append((name, d))
    for kind, names in kinds.items():
        worst = max(names, key=lambda r: r[1])
        print(f"    valid frames differ with equal valid inputs in {len(names)} {kind} (e.g. "
              f"{names[0][0]}; max|Δ| {worst[1]:.3g} in {worst[0]})", flush=True)
    print(f"    {len(origins)} origins of {len(own)} modules", flush=True)
    return origins


def cache_check(np, load_audio, runtime, cache_cls) -> float:
    """A window over 16 s through StreamingEncoderCache cold, then with its
    tail grown by 1 s: t_valid and ids equal to forward_long's and the
    log-probs within CACHE_TOL (the reference's contract,
    tests/test_runtime_long.py). Returns the largest |Δ log-prob|."""
    audio = load_audio(CORPUS / "long_033_056.wav")
    cache = cache_cls(runtime)
    worst = 0.0
    for seconds in (17.0, 18.0):
        window = audio[: int(seconds * 16000)]
        lp_c, ids_c, tv_c = cache.forward(window)
        lp_f, ids_f, tv_f = runtime.forward_long(window)
        delta = float((lp_c[:tv_c] - lp_f[:tv_f]).abs().max()) if tv_c == tv_f else float("nan")
        same = tv_c == tv_f and np.array_equal(ids_c, ids_f)
        print(f"  window {len(window)} samples: t_valid {tv_c} vs forward_long {tv_f}, ids "
              f"{'equal' if same else 'DIFFER'}, max|Δ log-prob| {delta:.4g}; hits {cache.hits} "
              f"misses {cache.misses}", flush=True)
        if not same:
            raise AssertionError("the streaming cache disagrees with forward_long")
        worst = max(worst, delta)
    if cache.hits < 1:
        raise AssertionError("the grown window did not reuse the cached chunk")
    return worst


def serve(np, manifest, load_audio) -> dict:
    """The port's server in-process with the tracker engine; two ws_client
    streams at once, each of which must get a verse_match for its clip's
    verse; then the port's ws_bench with WS_CLIENTS concurrent clients over
    the STREAM_IDS clips, flat out, each at sequence accuracy 1.0, with the
    per-message latency. Returns ws_bench's result."""
    from tilawa_tpu_torch.eval import ws_bench
    from tilawa_tpu_torch.streaming import ws as wslib
    from tilawa_tpu_torch.streaming import ws_client
    from tilawa_tpu_torch.streaming.server import ModelLoader, RecitationServer

    by_id = {s["id"]: s for s in manifest.values()}
    loaded = [(by_id[i], load_audio(CORPUS / by_id[i]["file"])) for i in STREAM_IDS]

    async def scenario():
        loader = ModelLoader(device=DEVICE).start()
        server = RecitationServer(loader, engine="tracker")
        srv = await wslib.serve(server.handle, "127.0.0.1", 0, http_handler=server.api.handle)
        port = srv.sockets[0].getsockname()[1]
        try:
            t = time.perf_counter()
            while not loader.ready:
                if loader.state.get("phase") == "error":
                    raise RuntimeError(f"model load failed: {loader.state}")
                if time.perf_counter() - t > 300:
                    raise TimeoutError(f"model not ready: {loader.state}")
                await asyncio.sleep(0.2)
            print(f"  server on 127.0.0.1:{port}: {loader.weights} ready in "
                  f"{time.perf_counter() - t:.1f} s ({loader.model_size_bytes} B)", flush=True)
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                results = await asyncio.gather(*(
                    ws_client.stream_file(str(CORPUS / clip), "127.0.0.1", port, wait_s=10.0)
                    for clip in SERVER_CLIPS))
            elapsed = time.perf_counter() - t
            micro = server._model_state().get("micro_batch", {})
            print(f"  two clients streamed in {elapsed:.1f} s; dispatcher {micro}", flush=True)
            for clip, messages in zip(SERVER_CLIPS, results):
                want = {(v["surah"], v["ayah"]) for v in manifest[clip]["expected_verses"]}
                got = [(m["surah"], m["ayah"]) for m in messages if m.get("type") == "verse_match"]
                print(f"  {clip}: {len(messages)} messages, verse_match {got}, expected "
                      f"{sorted(want)}", flush=True)
                if not want & set(got):
                    raise AssertionError(f"{clip}: no verse_match for {sorted(want)}")
            bench = await ws_bench.replay("127.0.0.1", port, loaded, clients=WS_CLIENTS)
        finally:
            srv.close()
            await srv.wait_closed()
        for r in bench["per_client"]:
            print(f"  ws_bench {r['id']:18s} seq_acc {r['sequence_accuracy']:.2f} got {r['got']} "
                  f"expected {r['expected']}; {r['messages']} messages, latency p50/p90 "
                  f"{r['message_latency_p50_s']}/{r['message_latency_p90_s']} s; wall "
                  f"{r['wall_s']} s for {r['audio_s']} s of audio", flush=True)
        print(f"  ws_bench: {bench['clients']} clients, {bench['n']} clips flat out in "
              f"{bench['wall_s']} s; per-message latency p50 {bench['message_latency_p50_s']} s "
              f"p90 {bench['message_latency_p90_s']} s over {bench['n_messages']} messages; "
              f"dispatcher {server._model_state().get('micro_batch', {})}", flush=True)
        wrong = [r["id"] for r in bench["per_client"] if r["sequence_accuracy"] != 1.0]
        if wrong or bench["n"] != len(STREAM_IDS):
            raise AssertionError(f"ws_bench below sequence accuracy 1.0: {wrong}")
        return bench

    previous = os.environ.get("TILAWA_CHECKPOINT")
    os.environ["TILAWA_CHECKPOINT"] = str(STREAM_BUNDLE)
    try:
        return asyncio.run(scenario())
    finally:
        if previous is None:
            del os.environ["TILAWA_CHECKPOINT"]
        else:
            os.environ["TILAWA_CHECKPOINT"] = previous


def profile_medians(per_sample: list[dict]) -> dict[str, tuple[float, int]]:
    """(median seconds, clips) of each TILAWA_PROFILE stage over the clips
    that ran it (a clip the text gate passes records build and rerank as 0,
    a clip without TTA no tta)."""
    out = {}
    for stage in ("forward", "decode", "build", "rerank", "tta"):
        vals = sorted(r["profile"][stage] for r in per_sample
                      if r.get("profile", {}).get(stage, 0.0) > 0.0
                      or (stage in ("forward", "decode") and "profile" in r))
        if vals:
            out[stage] = (vals[len(vals) // 2], len(vals))
    return out


def eval_path(torch, kernels, get_experiment, load_manifest, run_experiment) -> tuple:
    """c2c-direct-mixed-tta through the port's runner over every v1 sample:
    every scored clip must match its manifest, at least MIN_EVAL_CLIPS of
    them; launch counts zeroed just before and read just after. Returns
    (recognizer, result, launches)."""
    rec = get_experiment(MAIN_EXPERIMENT, DEVICE)
    rec.profile = True
    samples, corpus_dir = load_manifest("v1")
    torch.cuda.synchronize()
    kernels.reset_launches()
    rec.runtime.forwards = 0
    res = run_experiment(MAIN_EXPERIMENT, rec, samples, corpus_dir)
    torch.cuda.synchronize()
    launches, forwards = dict(kernels.LAUNCHES), rec.runtime.forwards
    rec.profile = False
    status: dict[str, list[str]] = {}
    for d in res["dispositions"]:
        status.setdefault(d["status"], []).append(d["file"] if "file" in d else d["id"])
    compressed = [f for f in status.get("undecodable", []) if f.endswith((".mp3", ".m4a"))]
    print(f"  {MAIN_EXPERIMENT}: N={res['total']} of {res['total_manifest']} manifest samples; "
          f"recall {res['recall']:.4f} precision {res['precision']:.4f} seq_acc "
          f"{res['sequence_accuracy']:.4f}", flush=True)
    for st, files in sorted(status.items()):
        print(f"  {st}: {len(files)} {sorted(files)}", flush=True)
    print(f"  mp3/m4a decode here: {'no' if compressed else 'yes'} "
          f"({len(compressed)} compressed clips undecodable)", flush=True)
    print(f"  latency p50 {res['p50_latency'] * 1e3:.2f} ms, mean {res['avg_latency'] * 1e3:.2f} "
          f"ms, p90 {res['p90_latency'] * 1e3:.2f} ms (host clock, warm-up excluded)", flush=True)
    print("  TILAWA_PROFILE stage medians over the clips that ran the stage (ms): " + ", ".join(
        f"{k} {v * 1e3:.2f} ({n})" for k, (v, n) in profile_medians(res["per_sample"]).items()),
        flush=True)
    print(f"  forwards {forwards}; launches {launches}", flush=True)
    if JAX_RECORDED_RUN.exists():
        recorded = json.loads(JAX_RECORDED_RUN.read_text())[0]["per_sample"]
        jax_pred = {r["id"]: [(e["surah"], e["ayah"]) for e in r["predicted"]] for r in recorded}
        same = sum(1 for r in res["per_sample"]
                   if jax_pred.get(r["id"]) == [(e["surah"], e["ayah"]) for e in r["predicted"]])
        print(f"  {same} of {res['total']} clips emit the verses of the JAX package's recorded "
              f"run ({JAX_RECORDED_RUN.name})", flush=True)
    else:
        print(f"  (the JAX package's recorded run {JAX_RECORDED_RUN.name} is not in this copy)",
              flush=True)
    if status.get("error"):
        raise AssertionError(f"clips that raised: {status['error']}")
    if (res["recall"], res["precision"], res["sequence_accuracy"]) != (1.0, 1.0, 1.0):
        wrong = [r["id"] for r in res["per_sample"] if r["sequence_accuracy"] != 1.0]
        raise AssertionError(f"clips that miss their manifest verses: {wrong}")
    if res["total"] < MIN_EVAL_CLIPS:
        raise AssertionError(f"only {res['total']} clips scored (want >= {MIN_EVAL_CLIPS})")
    if forwards == 0 or launches["int4_matmul"] != INT4_LAUNCHES_PER_FORWARD * forwards \
            or launches["log_mel"] != forwards:
        raise AssertionError("the eval path did not run every kernel once per layer and forward")
    return rec, res, launches


def other_experiments(get_experiment, load_manifest, run_experiment) -> None:
    """The other registered experiments over CLIPS; each must score every
    clip without an error disposition."""
    samples, corpus_dir = load_manifest("v1")
    samples = [s for s in samples if s["file"] in CLIPS]
    for name in OTHER_EXPERIMENTS:
        t = time.perf_counter()
        res = run_experiment(name, get_experiment(name, DEVICE), samples, corpus_dir)
        errors = [d for d in res["dispositions"] if d["status"] == "error"]
        print(f"  {name:24s} N={res['total']} recall {res['recall']:.4f} precision "
              f"{res['precision']:.4f} seq_acc {res['sequence_accuracy']:.4f} p50 "
              f"{res['p50_latency'] * 1e3:.2f} ms ({res['acoustics']} acoustics; "
              f"{time.perf_counter() - t:.1f} s with load)", flush=True)
        if errors or res["total"] != len(CLIPS):
            raise AssertionError(f"{name}: {len(errors)} errors, {res['total']} clips scored")


def no_sync_check(torch, np, runtime) -> dict:
    """forward_batch_async queues without a host sync.

    Gates: two B=8 calls at NO_SYNC_BUCKET run under
    torch.cuda.set_sync_debug_mode("error"), which raises on every
    synchronizing call PyTorch makes (a pageable upload raises under it:
    the negative control); and with NO_SYNC_SLEEP_S of device sleep queued
    first, the host reaches block HOOK_BLOCK of the first call (the
    uploads, the frontend and the blocks before it queued, some hundreds of
    launches, below the launch queue's depth) within NO_SYNC_SHARE of the
    sleep, while the device still sleeps. A pageable upload would make it
    wait out the sleep.

    Printed, not gated: the two calls' host enqueue and device time and
    whether the device is busy when they return, at NO_SYNC_BUCKET and
    BUSY_BUCKET. That depends on which side is slower: the host's enqueue
    of ~2,000 eager launches a B=8 forward, or the device."""
    rng = np.random.default_rng(SEED + 3)
    out = {}
    for n in (NO_SYNC_BUCKET, BUSY_BUCKET):
        waves = [(rng.standard_normal(n) * 0.1).astype(np.float32) for _ in range(BATCH)]
        runtime.forward_batch(waves)                      # warm the shape
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        if n == NO_SYNC_BUCKET:
            torch.cuda.set_sync_debug_mode("error")
        try:
            runtime.forward_batch_async(waves)
            runtime.forward_batch_async(waves)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host = time.perf_counter() - t
        busy = not torch.cuda.current_stream().query()
        end.record()
        torch.cuda.synchronize()
        device = start.elapsed_time(end) / 1e3
        print(f"  two B={BATCH} forward_batch_async at {n}"
              + (" (sync debug mode: error)" if n == NO_SYNC_BUCKET else "")
              + f": host enqueue {host * 1e3:.2f} ms, device {device * 1e3:.2f} ms "
                f"(ratio {host / device:.3f}), device busy at return: {busy}", flush=True)
        out[n] = {"host_s": host, "device_s": device, "busy": busy}
        if n == NO_SYNC_BUCKET:
            slept_waves = waves
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.from_numpy(np.zeros(8, np.float32)).to(DEVICE)
    except RuntimeError:
        print("  no synchronizing call in the two forwards; negative control: a pageable "
              "upload raises under the same mode", flush=True)
    else:
        raise AssertionError("sync debug mode did not catch a pageable upload")
    finally:
        torch.cuda.set_sync_debug_mode(0)

    reached: list[tuple[float, bool]] = []

    def stamp(_module, _args):
        if not reached:
            reached.append((time.perf_counter(), torch.cuda.current_stream().query()))

    torch.cuda.synchronize()
    handle = runtime.model.blocks[HOOK_BLOCK].register_forward_pre_hook(stamp)
    try:
        torch.cuda._sleep(int(NO_SYNC_SLEEP_S * SLEEP_CYCLES_PER_S))
        t = time.perf_counter()
        runtime.forward_batch_async(slept_waves)
        runtime.forward_batch_async(slept_waves)
    finally:
        handle.remove()
    torch.cuda.synchronize()
    at, idle = reached[0][0] - t, reached[0][1]
    print(f"  behind a {NO_SYNC_SLEEP_S:.1f} s device sleep the host reached block "
          f"{HOOK_BLOCK} of the first forward after {at * 1e3:.2f} ms, device "
          f"{'idle' if idle else 'still busy'}", flush=True)
    out["reached_s"] = at
    if idle or not at < NO_SYNC_SHARE * NO_SYNC_SLEEP_S:
        raise AssertionError(f"the queued forward waited for the device ({at:.4f} s, idle {idle})")
    return out


def batched_path(torch, np, kernels, frontend, rec, eval_res, audios) -> tuple[dict, dict]:
    """batched_corpus_eval at B=8 over the eval's decodable clips, counters
    zeroed just before and read just after: each clip's verses equal the
    eval's, recall and sequence accuracy 1.0, 189 int4 launches per
    forward. Then every clip's B=8 row against its B=1 forward (greedy ids
    equal, max |Δ log-prob| printed; the ops that vary with B named when
    it is not 0). Returns (result, launches)."""
    from tilawa_tpu_torch.eval.batched import batched_corpus_eval
    from tilawa_tpu_torch.eval.metrics import predict_to_emissions
    from tilawa_tpu_torch.pipeline.runtime import bucket_length

    runtime = rec.runtime
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runtime.forwards = 0
    res = batched_corpus_eval(rec, audios, batch_size=BATCH)
    torch.cuda.synchronize()
    launches, forwards = dict(kernels.LAUNCHES), runtime.forwards
    peak = torch.cuda.max_memory_allocated()
    print(f"  N={res['n']} audio {res['audio_s']} s: {res['audio_sec_per_sec']} audio-s/s; wall "
          f"{res['wall_s']} s, fetch_wait {res['fetch_wait_s']} s, decode {res['decode_s']} s, "
          f"predict {res['predict_s']} s; TTA clips {res['n_tta']}; recall {res['recall']} "
          f"seq_acc {res['seq_acc']}; peak memory {peak} B", flush=True)
    print(f"  forwards {forwards} (warm-up included); launches {launches}", flush=True)
    eval_pred = {r["id"]: [(e["surah"], e["ayah"]) for e in r["predicted"]]
                 for r in eval_res["per_sample"]}
    differ = [sid for sid, p in res["predictions"].items()
              if [(e["surah"], e["ayah"]) for e in predict_to_emissions(p)] != eval_pred[sid]]
    if differ:
        raise AssertionError(f"batched verses differ from the eval's: {differ}")
    if res["recall"] != 1.0 or res["seq_acc"] != 1.0:
        raise AssertionError(f"batched recall {res['recall']} seq_acc {res['seq_acc']}")
    if forwards == 0 or launches["int4_matmul"] != INT4_LAUNCHES_PER_FORWARD * forwards \
            or launches["log_mel"] != forwards:
        raise AssertionError("the batched path did not run every kernel once per layer and forward")

    groups: dict[int, list] = {}
    for sid, audio, _exp in audios:
        groups.setdefault(bucket_length(len(audio)), []).append((sid, audio))
    worst, worst_bucket, wrong = 0.0, None, []
    for bucket, clips in sorted(groups.items()):
        for pos in range(0, len(clips), BATCH):
            chunk = clips[pos:pos + BATCH]
            waves = [a for _s, a in chunk] + [np.zeros(bucket, np.float32)] * (BATCH - len(chunk))
            lp_b, lens_b, ids_b = runtime.forward_batch(waves)
            for j, (sid, audio) in enumerate(chunk):
                lp_1, ids_1, t_1 = runtime.forward(audio)
                t_b = int(lens_b[j])
                if t_b != t_1 or not np.array_equal(ids_b[j, :t_b], ids_1):
                    wrong.append(sid)
                    worst_bucket = worst_bucket or bucket
                    continue
                delta = float((lp_b[j, :t_1] - lp_1[:t_1]).abs().max())
                if delta > worst:
                    worst, worst_bucket = delta, bucket
    print(f"  B={BATCH} rows against B=1 forwards: greedy ids equal for "
          f"{len(audios) - len(wrong)} of {len(audios)} clips; max|Δ log-prob| {worst:.4g}",
          flush=True)
    if worst_bucket is not None:
        from tilawa_tpu_torch.data.audio import load_audio

        print(f"  the ops that vary with the batch size at B={BATCH}, N={worst_bucket}:",
              flush=True)
        batch_variance(torch, np, runtime, frontend, load_audio(CORPUS / "long_033_056.wav"),
                       rows=BATCH, n=worst_bucket)
    if wrong:
        raise AssertionError(f"B={BATCH} greedy ids differ from B=1 for {wrong}")
    return res, launches


def bench_child() -> dict:
    """python -m tilawa_tpu_torch.bench as a child process with a budget:
    its JSON line must be whole (partial false, no error) with recall,
    sequence accuracy and batched recall 1.0."""
    env = dict(os.environ, BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    proc = subprocess.run([sys.executable, "-m", "tilawa_tpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=BENCH_BUDGET_S + 120)
    for line in proc.stderr.strip().splitlines()[-12:]:
        print(f"    {line}", flush=True)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  {json.dumps(line)}", flush=True)
    bad = {k: line.get(k) for k in ("partial", "recall", "seq_acc", "batched_recall")
           if line.get(k) != (False if k == "partial" else 1.0)}
    if proc.returncode != 0 or "error" in line or "batched_error" in line or bad:
        raise AssertionError(f"bench: rc {proc.returncode}, {bad}, error {line.get('error')}")
    return line


def host_ms(runtime, recognizer, audio) -> tuple[float, float]:
    """Host-clock milliseconds of one forward (it ends in a host read of the
    ids) and one predict of a clip."""
    t = time.perf_counter()
    runtime.forward(audio)
    fwd = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    recognizer.predict_audio(audio)
    return fwd, (time.perf_counter() - t) * 1e3


def device_busy(torch, runtime, audio, fwd_ms: float, top: int) -> dict | None:
    """One forward under torch.profiler: device busy time, its share of the
    host-clock forward, the `top` kernels by device time, and per forward
    the launches of the quantized matmul and of any split-K sum kernel, the
    log-mel kernel's launches and device time, and the aten::copy_ and
    aten::add calls. None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runtime.forward(audio)
        torch.cuda.synchronize()
    stats = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(device_us(e) for e in stats) / 1e3
    if busy_ms <= 0:
        print("    profiler saw no device time: device busy share not measured", flush=True)
        return None
    counts = {
        "matmul_kernels": sum(e.count for e in stats if "quant_matmul_kernel" in e.key),
        "matmul_ms": sum(device_us(e) for e in stats if "quant_matmul_kernel" in e.key) / 1e3,
        "splitk_kernels": sum(e.count for e in stats if "splitk" in e.key.lower()),
        "copy_": sum(e.count for e in stats if e.key == "aten::copy_"),
        "add": sum(e.count for e in stats if e.key == "aten::add"),
        "mel_kernels": sum(e.count for e in stats if "log_mel_kernel" in e.key),
        "mel_ms": sum(device_us(e) for e in stats if "log_mel_kernel" in e.key) / 1e3,
    }
    print(f"    profiled forward: device busy {busy_ms:.3f} ms "
          f"= {100 * busy_ms / fwd_ms:.1f}% of the median forward; quant matmul "
          f"{counts['matmul_kernels']} launches {counts['matmul_ms']:.3f} ms, log-mel "
          f"{counts['mel_kernels']} launch {counts['mel_ms']:.4f} ms, split-K sum "
          f"kernels {counts['splitk_kernels']}, aten::copy_ {counts['copy_']}, aten::add "
          f"{counts['add']}", flush=True)
    for e in sorted(stats, key=device_us, reverse=True)[:top]:
        print(f"    {device_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}", flush=True)
    return counts


def check_profile(counts: dict | None, what: str) -> None:
    """One quantized-matmul launch per product and no split-K sum kernel."""
    if counts is None:
        return
    if counts["matmul_kernels"] != INT4_LAUNCHES_PER_FORWARD or counts["splitk_kernels"]:
        raise AssertionError(f"{what}: the profiler saw {counts['matmul_kernels']} quantized "
                             f"matmul and {counts['splitk_kernels']} split-K sum launches "
                             f"(want {INT4_LAUNCHES_PER_FORWARD} and 0)")


def trace(torch, runtime, recognizer, clips, reps: int = 12) -> None:
    """Where a clip's time goes: `reps` forwards and predicts of each clip on
    the host clock, then one forward under torch.profiler."""
    for name, audio in clips:
        host_ms(runtime, recognizer, audio)
        fwd, pred = zip(*(host_ms(runtime, recognizer, audio) for _ in range(reps)))
        fwd_ms, pred_ms = sorted(fwd)[reps // 2], sorted(pred)[reps // 2]
        print(f"  {name}: median of {reps}: forward {fwd_ms:.2f} ms (host clock, ends in a "
              f"host read), predict {pred_ms:.2f} ms", flush=True)
        check_profile(device_busy(torch, runtime, audio, fwd_ms, top=8), name)


# ---------------------------------------------------------------------------
# The training path (train.finetune's recipe, distillation, export)


def _bn_stats(model) -> dict:
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith((".mean", ".var"))}


@contextmanager
def sync_census(torch):
    """Every synchronizing CUDA call made inside, as a Python warning
    (torch.cuda.set_sync_debug_mode("warn"), which acts only at such a
    call) whose file and line are those of the innermost Python frame: the
    library or port function that made it."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(0)


def sync_sites(seen: list, lo: int, hi: int) -> dict[str, int]:
    """The synchronizing calls among seen[lo:hi], counted by file:line."""
    sites: dict[str, int] = {}
    for w in seen[lo:hi]:
        if "synchronizing" in str(w.message):
            path = Path(w.filename).as_posix()
            for root in ("site-packages/", "tilawa_tpu_torch/"):
                if root in path:
                    path = (root if root.startswith("tilawa") else "") + path.split(root, 1)[1]
                    break
            key = f"{path}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def timed_steps(steps: list[dict], start) -> None:
    """Each step's ms from the CUDA events its callback recorded: from the
    previous step's `resume` (after the callback's own device work) to the
    step's `end`."""
    prev = start
    for s in steps:
        s["ms"] = prev.elapsed_time(s["end"])
        prev = s["resume"]


def check_syncs(steps: list[dict], seen: list, first: int, what: str) -> dict[str, int]:
    """Sync sites per step from `first` on (the steps before it hold the
    loss read logged at step 0 and the first step's lazy set-up): printed;
    a synchronizing call from the port's own code fails."""
    per_step = [sync_sites(seen, a["warnings"], b["warnings"])
                for a, b in zip(steps[first - 1:], steps[first:])]
    sites: dict[str, int] = {}
    for d in per_step:
        for k, v in d.items():
            sites[k] = sites.get(k, 0) + v
    print(f"  synchronizing calls in {what} steps {first}..{len(steps) - 1}: "
          f"{[sum(d.values()) for d in per_step]} a step, at {sites or 'none'}", flush=True)
    ours = [k for k in sites if k.startswith("tilawa_tpu_torch/")]
    if ours:
        raise AssertionError(f"{what}: the port's own code synchronizes in a step at {ours}")
    return sites


def train_phase(torch, np, kernels, ckpt_dir: Path) -> dict:
    """train.finetune's recipe at full width from the dequantized
    champion-int4 over bucketed v1 batches (crop_prob 0.35), TRAIN_STEPS
    steps, with finetune's own log_every (the loss is read at step 0 and at
    the last step). Per step: bucket, loss, step ms (CUDA events: from the
    end of the callback's work after the previous step to the end of this
    one: the device's work for the step and any wait for the host), audio-s/s
    over the batch's valid samples, launches. The callback compares the
    parameters with the champion's on the device after steps 0 and 1 (one
    flag a parameter, no host sync) and records
    its events around that work; they are read after the run. The steps
    run under sync_census. Asserts finite losses, no parameter moved by step
    0 (lr 0), parameters moved by step 1, frozen BatchNorm stats, one log-mel
    launch a step and no int4 launch, no synchronizing call of the port's
    own code in steps 2.."""
    from tilawa_tpu_torch.models.convert import params_from_jax
    from tilawa_tpu_torch.models.fastconformer import forward_flops
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.finetune import finetune
    from tilawa_tpu_torch.train.quantize import dequantize_variables

    _cfg, variables = load_variables(CHAMPION)
    ref = {k: v.to(DEVICE) for k, v in params_from_jax(dequantize_variables(variables)).items()}
    steps: list[dict] = []
    names = list(ref)
    moved: dict[int, object] = {}
    state_of: dict = {}
    start = torch.cuda.Event(enable_timing=True)

    def callback(i, state, batch, loss):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        if i in (0, 1):   # step 0 moves nothing, so "differs" after step 1 is step 1's move
            params = dict(state.model.named_parameters())
            moved[i] = torch.stack([torch.ne(params[n].detach(), ref[n]).any() for n in names
                                    if n in params])
        resume = torch.cuda.Event(enable_timing=True)
        resume.record()
        steps.append({"i": i, "shape": batch[0].shape, "samples": int(batch[1].sum()),
                      "loss": loss, "end": end, "resume": resume, "launches": launches,
                      "warnings": len(seen)})
        state_of["model"] = state.model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with sync_census(torch) as seen:
        start.record()
        finetune(init=CHAMPION, checkpoint_dir=ckpt_dir, steps=TRAIN_STEPS, corpora=("v1",),
                 seed=SEED, crop_prob=0.35, device=DEVICE,
                 checkpoint_every=TRAIN_STEPS + 1, callback=callback)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    model = state_of["model"]
    cfg = model.cfg
    timed_steps(steps, start)
    for s in steps:
        b, n = s["shape"]
        s["audio_s_s"] = s["samples"] / 16000 / (s["ms"] / 1e3)
        s["mfu"] = 3 * b * forward_flops(cfg, n / 16000) / (s["ms"] / 1e3) / BF16_FLOPS_S
        print(f"  step {s['i']}: {b} x {n / 16000:g} s, loss {float(s['loss']):.4f}, "
              f"{s['ms']:.2f} ms, {s['audio_s_s']:.1f} audio-s/s, MFU {s['mfu']:.4f}, "
              f"launches {s['launches']}", flush=True)
    syncs = check_syncs(steps, seen, 2, "train")
    params = [n for n in names if n in dict(model.named_parameters())]
    step0_moved = [n for n, f in zip(params, moved[0].tolist()) if f]
    step1_moved = sum(moved[1].tolist())
    print(f"  peak memory {peak} B; step 0 moved {len(step0_moved)} parameters, "
          f"step 1 moved {step1_moved} of {len(params)}", flush=True)
    bn_ref = {n: v for n, v in ref.items() if n.endswith((".mean", ".var"))}
    bn_moved = [n for n, b in _bn_stats(model).items() if not torch.equal(b, bn_ref[n])]
    if not all(np.isfinite(float(s["loss"])) for s in steps):
        raise AssertionError("a training loss is not finite")
    if step0_moved:
        raise AssertionError(f"step 0 (lr 0) moved {step0_moved[:5]}")
    if not step1_moved:
        raise AssertionError("step 1 moved no parameter")
    if bn_moved:
        raise AssertionError(f"frozen BatchNorm stats moved: {bn_moved[:5]}")
    bad = [s["i"] for s in steps if s["launches"]["log_mel"] != 1 or s["launches"]["int4_matmul"]
           or s["launches"]["ctc_loss"] != CTC_LOSS_LAUNCHES_PER_STEP]
    if bad:
        raise AssertionError(f"steps {bad}: want 1 log-mel, {CTC_LOSS_LAUNCHES_PER_STEP} "
                             "ctc_loss and 0 int4 launches a step")
    timed = steps[1:]
    med = sorted(timed, key=lambda s: s["ms"])[len(timed) // 2]
    return {"checkpoint": ckpt_dir / f"step_{TRAIN_STEPS:06d}", "peak_bytes": peak,
            "step_ms": med["ms"], "bucket": f"{med['shape'][0]}x{med['shape'][1] / 16000:g}s",
            "step_ms_by_bucket": {f"{s['shape'][0]}x{s['shape'][1] / 16000:g}s": [
                t["ms"] for t in timed if t["shape"] == s["shape"]] for s in timed},
            "audio_s_s": sum(s["samples"] for s in timed) / 16000
            / (sum(s["ms"] for s in timed) / 1e3),
            "mfu": sum(3 * s["shape"][0] * forward_flops(cfg, s["shape"][1] / 16000)
                       for s in timed) / (sum(s["ms"] for s in timed) / 1e3) / BF16_FLOPS_S,
            "sync_sites": syncs,
            "log_mel_launches": sum(s["launches"]["log_mel"] for s in steps),
            "ctc_loss_launches": sum(s["launches"]["ctc_loss"] for s in steps)}


def fit_report_phase(torch, kernels, checkpoint: Path) -> dict:
    """train/fit_report.py's corpus_fit on the card: the train phase's
    checkpoint over the v1 clips up to FIT_REPORT_MAX_S seconds, in its
    bucketed batches under inference_mode, the loss through the CTC loss
    kernel. Counters zeroed just before and read just after: one ctc_loss
    launch a batch (one forward, no backward), as many as the batches'
    log-mel launches; every row's loss finite and positive."""
    from tilawa_tpu_torch.train.fit_report import corpus_fit

    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    rows = corpus_fit(str(checkpoint), ("v1",), max_audio_s=FIT_REPORT_MAX_S, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    losses = [r["loss"] for r in rows]
    print(f"  fit_report over {len(rows)} v1 clips up to {FIT_REPORT_MAX_S:g} s in {wall:.2f} s: "
          f"launches {launches}; loss min {min(losses):.3f} max {max(losses):.3f}; worst "
          f"{rows[0]['id']}", flush=True)
    if not rows or launches["ctc_loss"] < 1 or launches["ctc_loss"] != launches["log_mel"]:
        raise AssertionError(f"fit_report: want one ctc_loss and one log-mel launch a batch, "
                             f"got {launches} over {len(rows)} clips")
    if not all(0 < x < float("inf") for x in losses):
        raise AssertionError(f"fit_report: a loss is not finite and positive: {losses}")
    return {"clips": len(rows), "launches": launches, "wall_s": wall}


def _step_loss(torch, model, batch, generator):
    """One training step's forward, CTC loss and backward (frozen BatchNorm,
    the model's own dropout and SpecAugment), no update; the loss."""
    from tilawa_tpu_torch.device import upload
    from tilawa_tpu_torch.train.train import ctc_loss_fn, encoder_lengths

    audio, lens, tokens, tlens = batch
    model.zero_grad(set_to_none=True)
    lp, _ = model(upload(audio, model.mel_window.device), upload(lens, model.mel_window.device),
                  deterministic=False, use_running_average=True, generator=generator)
    loss = ctc_loss_fn(lp, encoder_lengths(lens), tokens, tlens, model.cfg.blank_id)
    loss.backward()
    return loss.detach()


def _one_step(torch, model, batch, generator):
    """Loss and gradients of one training step before any update."""
    loss = _step_loss(torch, model, batch, generator)
    return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _leaf_delta(a: dict, b: dict, floor_of: float | None = GRAD_FLOOR) -> tuple[float, str]:
    """The largest per-leaf max|Δ|/max|a| between two {name: tensor} maps,
    over the leaves whose max|a| is at least floor_of of the largest (None:
    every leaf)."""
    top = max(float(t.abs().max()) for t in a.values())
    worst, where = 0.0, ""
    for n, t in a.items():
        m = float(t.abs().max())
        if m > 0 and (floor_of is None or m >= floor_of * top):
            r = float((t.float() - b[n].float()).abs().max()) / m
            if r > worst:
                worst, where = r, n
    return worst, where


def _step_delta(a, b) -> tuple[float, float, str]:
    """|Δ loss| and the largest per-leaf max|Δg|/max|g| (leaves whose
    gradient is at least GRAD_FLOOR of the whole gradient's largest; below
    it a leaf holds rounding noise, as the key bias does: zero in exact
    arithmetic under the softmax's shift invariance)."""
    (la, ga), (lb, gb) = a, b
    return (abs(la - lb), *_leaf_delta(ga, gb))


def noisy_features(torch, frontend, model, noise) -> None:
    """Hooks on `model` that give its subsampling the plain log-mel of the
    forward's audio plus uniform noise of ±MEL_TOL (drawn from `noise`),
    normalized as log_mel_spectrogram does: the kernel's error bound, put
    where the kernel's output goes. Without the noise the hooks must give
    back bit for bit the features the model computed (checked each call)."""
    given = {}

    def keep(_module, args):
        given["audio"], given["lengths"] = args[0], args[1]

    def replace(_module, args):
        feats, lengths = args
        logmel = frontend.log_mel_plain(preemphasize(torch, frontend, given["audio"]),
                                        model.tables())
        clean, _ = frontend.normalize_log_mel(logmel, given["lengths"])
        if not torch.equal(bits(torch, clean), bits(torch, feats)):
            raise AssertionError("noisy_features: the plain features differ from the model's")
        drawn = (torch.rand(logmel.shape, generator=noise, device=logmel.device) * 2 - 1) * MEL_TOL
        return frontend.normalize_log_mel(logmel + drawn, given["lengths"])[0], lengths

    model.register_forward_pre_hook(keep)
    model.subsampling.register_forward_pre_hook(replace)


def train_vs_plain(torch, np) -> dict:
    """One step on one fixed v1 batch from the dequantized champion, dropout
    0 and SpecAugment off, with the log-mel kernel and with the plain
    log-mel, in f32 and in bf16 compute. Tolerance, measured in the same
    run: the deltas of the same step with the plain log-mel plus uniform
    noise of ±MEL_TOL, the bound the kernel is held to against its plain
    version — the kernel's |Δ loss| and per-leaf gradient delta must not
    exceed what an error of the kernel's own bound does to the step. Gated
    in f32, where the step is smooth in its features; in bf16 any change of
    the features flips roundings through the 17 blocks, so kernel and noise
    deltas come out alike whatever the size of the change: printed, not
    gated. The plain step run twice must be bitwise equal, loss and every
    gradient leaf, in both types (its deltas, the floor, read 0). The
    noisy run's features come from hooks on its own
    model (noisy_features): the plain log-mel of its audio plus the noise,
    then the frontend's normalization. Then one bf16 kernel step under
    torch.profiler."""
    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.models.fastconformer import FastConformerCTC
    from tilawa_tpu_torch.ops import frontend
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.data import bucketed_corpus_batches
    from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config
    from tilawa_tpu_torch.train.train import step_generator

    cfg, variables = load_variables(CHAMPION)
    variables = dequantize_variables(variables)
    batch = next(bucketed_corpus_batches(("v1",), seed=SEED + 1, augment=False))
    gen = lambda: step_generator(SEED, 1, torch.device(DEVICE))  # noqa: E731
    noise = torch.Generator(device=DEVICE)

    def model_for(dtype, use_pallas):
        c = dequantized_config(cfg, dtype=dtype, use_pallas=use_pallas, dropout=0.0,
                               sa_freq_masks=0, sa_time_masks=0)
        return load_into(FastConformerCTC(c), variables).to(DEVICE)

    print(f"  batch {batch[0].shape[0]} x {batch[0].shape[1] / 16000:g} s", flush=True)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        noise.manual_seed(SEED)
        for name, use_pallas in (("kernel", True), ("plain", False), ("plain again", False),
                                 ("plain + noise", False)):
            model = model_for(dtype, use_pallas)
            if name == "plain + noise":
                noisy_features(torch, frontend, model, noise)
            runs[name] = _one_step(torch, model, batch, gen())
            del model
        kernel = _step_delta(runs["kernel"], runs["plain"])
        floor = _step_delta(runs["plain again"], runs["plain"])
        tol = _step_delta(runs["plain + noise"], runs["plain"])
        tag = str(dtype).removeprefix("torch.")
        print(f"  {tag}: loss {runs['plain'][0]:.5f}", flush=True)
        for what, (dl, dg, where) in (("kernel vs plain", kernel), ("plain again vs plain", floor),
                                      (f"plain + ±{MEL_TOL} log-mel noise vs plain", tol)):
            print(f"    {what}: |Δ loss| {dl:.4g}, largest per-leaf max|Δg|/max|g| {dg:.4g} "
                  f"({where})", flush=True)
        # the step is bitwise repeatable (C.10): every leaf, however small
        (la, ga), (lb, gb) = runs["plain again"], runs["plain"]
        moved = [n for n in ga if not torch.equal(bits(torch, ga[n]), bits(torch, gb[n]))]
        if la != lb or moved:
            raise AssertionError(f"{tag}: the plain step run twice differs (loss {la} vs {lb}; "
                                 f"{len(moved)} gradient leaves, e.g. {moved[:4]})")
        out[tag] = {"d_loss": kernel[0], "d_grad": kernel[1], "tol_loss": tol[0],
                    "tol_grad": tol[1], "floor_loss": floor[0], "floor_grad": floor[1]}
    f32 = out["float32"]
    if not (f32["d_loss"] <= f32["tol_loss"] and f32["d_grad"] <= f32["tol_grad"]):
        raise AssertionError(f"f32 kernel vs plain step {f32} beyond the tolerance")
    out["profile"] = _profile_step(torch, model_for(torch.bfloat16, True), batch, gen)
    return out


def _profile_step(torch, model, batch, gen) -> dict:
    """One bf16 training step with the kernels (forward, CTC, backward)
    under torch.profiler after a warm-up: device busy time against the
    step's host wall time, and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    _step_loss(torch, model, batch, gen())
    torch.cuda.synchronize()
    t = time.perf_counter()
    _step_loss(torch, model, batch, gen())
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _step_loss(torch, model, batch, gen())
        torch.cuda.synchronize()
    stats = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(device_us(e) for e in stats) / 1e3
    launches = sum(e.count for e in stats if device_us(e) > 0 and not e.key.startswith("aten::"))
    print(f"  profiled bf16 step (forward, CTC, backward; no optimizer): host wall {wall:.2f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)", flush=True)
    for e in sorted(stats, key=device_us, reverse=True)[:8]:
        print(f"    {device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}", flush=True)
    return {"wall_ms": wall, "device_busy_ms": busy, "device_kernel_events": launches}


def distill_phase(torch, np, kernels) -> dict:
    """distill.train_distill: student the dequantized champion, teacher
    champion-int4 on the int4 kernel, distill_batches over v1, DISTILL_STEPS
    steps, with its own log_every (the losses are read at step 0 and at the
    last step), step ms as in train_phase, under sync_census. Asserts the
    same-weights KL on the first batch's full clips within SAME_WEIGHTS_KL,
    INT4_LAUNCHES_PER_FORWARD int4 launches a step (one teacher forward),
    two log-mel launches (teacher and student), finite losses, and no
    synchronizing call of the port's own code in steps 2.."""
    from tilawa_tpu_torch.device import upload
    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.models.fastconformer import FastConformerCTC
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.distill import distill_batches, load_teacher, train_distill
    from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config

    # the same weights on the same full clips: teacher (int4 kernel) against
    # the dequantized student, both deterministic, over the first batch
    cfg, variables = load_variables(CHAMPION)
    student = load_into(FastConformerCTC(dequantized_config(cfg)),
                        dequantize_variables(variables)).to(DEVICE)
    teacher = load_teacher(CHAMPION, DEVICE)
    first = next(distill_batches(corpora=("v1",), seed=SEED))
    with torch.no_grad():
        audio, lens = upload(first[0], torch.device(DEVICE)), upload(first[1], torch.device(DEVICE))
        t_lp, t_len = teacher(audio, lens)
        s_lp, _ = student(audio, lens)
        mask = (torch.arange(t_lp.shape[1], device=DEVICE)[None, :] < t_len[:, None]).float()
        kl = torch.sum(torch.exp(t_lp) * (t_lp - s_lp), dim=-1)
        full_kl = float(torch.sum(kl * mask) / torch.sum(mask))
    del student, teacher
    print(f"  KL(teacher || student) on the first batch's full clips, no crop, no dropout: "
          f"{full_kl:.3g} (bound {SAME_WEIGHTS_KL})", flush=True)
    if not full_kl <= SAME_WEIGHTS_KL:
        raise AssertionError(f"the int4 teacher and the dequantized student disagree: KL "
                             f"{full_kl} > {SAME_WEIGHTS_KL}")

    steps = []
    start = torch.cuda.Event(enable_timing=True)

    def callback(i, state, batch, out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        steps.append({"i": i, "shape": batch[0].shape, "out": out, "end": end, "resume": end,
                      "launches": dict(kernels.LAUNCHES), "warnings": len(seen)})
        kernels.reset_launches()

    kernels.reset_launches()
    with sync_census(torch) as seen:
        start.record()
        train_distill(CHAMPION, CHAMPION, distill_batches(corpora=("v1",), seed=SEED),
                      DISTILL_STEPS, seed=SEED, device=DEVICE, callback=callback)
        torch.cuda.synchronize()
    timed_steps(steps, start)
    for s in steps:
        loss, kl, ctc = (float(v) for v in s["out"])
        print(f"  step {s['i']}: {s['shape'][0]} x {s['shape'][1] / 16000:g} s, KL {kl:.5f}, "
              f"aux CTC {ctc:.4f}, loss {loss:.4f}, {s['ms']:.2f} ms, launches "
              f"{s['launches']}", flush=True)
    bad = [s["i"] for s in steps if s["launches"]["int4_matmul"] != INT4_LAUNCHES_PER_FORWARD
           or s["launches"]["log_mel"] != 2
           or s["launches"]["ctc_loss"] != CTC_LOSS_LAUNCHES_PER_STEP]
    if bad:
        raise AssertionError(f"steps {bad}: want {INT4_LAUNCHES_PER_FORWARD} int4 launches "
                             f"(the teacher), 2 log-mel and {CTC_LOSS_LAUNCHES_PER_STEP} ctc_loss "
                             "launches a step")
    if not all(np.isfinite([float(v) for v in s["out"]]).all() for s in steps):
        raise AssertionError("a distillation loss is not finite")
    syncs = check_syncs(steps, seen, 2, "distill")
    timed = steps[1:]
    return {"step_ms": sorted(s["ms"] for s in timed)[len(timed) // 2],
            "step_ms_all": [s["ms"] for s in timed], "sync_sites": syncs,
            "first_kl": float(steps[0]["out"][1]), "first_kl_full_rows": full_kl,
            "int4_launches": sum(s["launches"]["int4_matmul"] for s in steps),
            "log_mel_launches": sum(s["launches"]["log_mel"] for s in steps),
            "ctc_loss_launches": sum(s["launches"]["ctc_loss"] for s in steps)}


def export_phase(torch, kernels, checkpoint: Path, out: Path, manifest: dict) -> None:
    """export.export_bundle of the train phase's checkpoint as int4:
    verify_bundle true for every file, the server's sha256 check accepts
    it, and Recognizer(tta=True) on it gets every CLIPS clip right with
    INT4_LAUNCHES_PER_FORWARD int4 launches a forward."""
    from tilawa_tpu_torch.eval.experiments import load_runtime
    from tilawa_tpu_torch.eval.metrics import best_emission_score, predict_to_emissions
    from tilawa_tpu_torch.io.bundle import read_variables
    from tilawa_tpu_torch.pipeline.predict import Recognizer
    from tilawa_tpu_torch.streaming.server import ModelLoader
    from tilawa_tpu_torch.train.export import export_bundle, verify_bundle

    export_bundle(checkpoint, out, quant="int4")
    verified = verify_bundle(out)
    print(f"  verify_bundle: {verified}", flush=True)
    if not all(verified.values()):
        raise AssertionError(f"verify_bundle failed: {verified}")
    champion = read_variables(CHAMPION)
    mine = read_variables(out)
    differ = [k for k, a in _flat_leaves(champion) if not (
        a.shape == _get(mine, k).shape and (a == _get(mine, k)).all())]
    print(f"  {len(differ)} of {sum(1 for _ in _flat_leaves(champion))} leaves differ from "
          f"champion-int4 after {TRAIN_STEPS} steps", flush=True)
    previous = os.environ.get("TILAWA_CHECKPOINT")
    os.environ["TILAWA_CHECKPOINT"] = str(out)
    try:
        loader = ModelLoader(warmup=False, device=DEVICE)
        loader._load()
    finally:
        if previous is None:
            os.environ.pop("TILAWA_CHECKPOINT")
        else:
            os.environ["TILAWA_CHECKPOINT"] = previous
    print(f"  server loader: {loader.state['phase']}", flush=True)
    if loader.state["phase"] != "ready":
        raise AssertionError(f"the server refused the bundle: {loader.state}")
    del loader
    runtime = load_runtime(out, DEVICE, long_chunking=False)
    recognizer = Recognizer(runtime, tta=True)
    kernels.reset_launches()
    runtime.forwards = 0
    wrong = []
    for clip in CLIPS:
        pred = recognizer.predict(CORPUS / clip)
        sample = manifest[clip]
        acc = best_emission_score(sample["expected_verses"], predict_to_emissions(pred),
                                  sample.get("also_accept"))["sequence_accuracy"]
        print(f"  {clip:24s} -> {pred['surah']}:{pred['ayah']}-{pred['ayah_end']} "
              f"{'ok' if acc == 1.0 else 'WRONG'}", flush=True)
        if acc != 1.0:
            wrong.append(clip)
    torch.cuda.synchronize()
    launches, forwards = dict(kernels.LAUNCHES), runtime.forwards
    print(f"  forwards {forwards}; launches {launches}", flush=True)
    if wrong:
        raise AssertionError(f"the exported bundle got {wrong} wrong")
    if not forwards or launches["int4_matmul"] != INT4_LAUNCHES_PER_FORWARD * forwards:
        raise AssertionError("the exported bundle did not run 189 int4 launches a forward")


def _verses(entries) -> list[tuple[int, int]]:
    return [(e["surah"], e["ayah"]) for e in entries or []]


def streaming_corpus(torch, kernels, rerank, validate_streaming,
                     recognizer) -> tuple[dict, dict]:
    """Every decodable v1 clip through validate_streaming's tracker on
    stream6-int8 in 300 ms chunks (counters zeroed just before, read just
    after), each clip's emissions and final sequence against the JAX
    package's replay of the same clips on the CPU (jax_refs.STREAM_REF,
    written live by tests/test_torch_refs.py); the 2026-08-21 record it
    replaces (JAX_STREAM_RUN) is printed beside it. Gates: at least
    MIN_EVAL_CLIPS clips, the final sequence equal to the reference's on
    every clip, the STREAM_IDS at sequence accuracy 1.0, 189 int8 + 1
    log-mel launches a forward, one lattice launch a scorer chunk. Returns
    (result, launches, the p50 ms of its forwards: host clock, each ending in
    the read of its ids)."""
    from tilawa_tpu_torch.eval.jax_refs import STREAM_REF, load_ref

    runtime = recognizer.runtime
    forward_s: list[float] = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    runtime.forwards = 0
    t = time.perf_counter()
    with lattice_record(torch, rerank, replay=False) as lattice, \
            timed_calls(runtime, "forward", forward_s):
        res = validate_streaming.run_validation(
            recognizer.transcribe_result, db=recognizer.db, token_store=recognizer.token_store,
            verbose=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, forwards = dict(kernels.LAUNCHES), runtime.forwards
    ref = load_ref(STREAM_REF)
    recorded = {r["id"]: r for r in json.loads(JAX_STREAM_RUN.read_text())[0]["per_sample"]}
    ours = {r["id"]: r for r in res["per_sample"]}
    same_final = [i for i, r in ours.items()
                  if _pairs(r["final_sequence"] or []) == (ref[i]["final_sequence"] or [])
                  and (r["final_sequence"] is None) == (ref[i]["final_sequence"] is None)]
    same_emitted = [i for i, r in ours.items() if _pairs(r["predicted"]) == ref[i]["predicted"]]
    old_final = [i for i, r in ours.items()
                 if _verses(r["final_sequence"]) == _verses(recorded[i]["final_sequence"])]
    for i, r in ours.items():
        print(f"  {i:22s} seq_acc {r['sequence_accuracy']:.2f} (JAX "
              f"{ref[i]['sequence_accuracy']:.2f})  final {_pairs(r['final_sequence'] or [])}"
              + ("" if i in same_final else f" vs JAX {ref[i]['final_sequence']}")
              + f"  wall {r['latency']:.2f} s", flush=True)
    print(f"  {res['total']} clips ({res['skipped']} skipped) in {wall:.1f} s: seq_acc "
          f"{res['sequence_accuracy']:.4f}, viterbi {res['viterbi_sequence_accuracy']:.4f}, "
          f"recall {res['recall']:.4f}; decode feed p50/p90 {res['decode_cycle_p50'] * 1e3:.1f}/"
          f"{res['decode_cycle_p90'] * 1e3:.1f} ms; {forwards} forwards, p50/p90 "
          f"{_pcts(forward_s)} ms", flush=True)
    ref_acc = sum(ref[i]["sequence_accuracy"] for i in ours) / max(len(ours), 1)
    print(f"  against the JAX reference {STREAM_REF.name} (seq_acc {ref_acc:.4f} on these "
          f"clips): final sequence equal on {len(same_final)} of {len(ours)}, emissions on "
          f"{len(same_emitted)}; against the 2026-08-21 record {JAX_STREAM_RUN.name}: final "
          f"sequence equal on {len(old_final)}", flush=True)
    wrong = [i for i in STREAM_IDS if ours.get(i, {}).get("sequence_accuracy") != 1.0]
    if wrong:
        raise AssertionError(f"streaming clips below sequence accuracy 1.0: {wrong}")
    if res["total"] < MIN_EVAL_CLIPS:
        raise AssertionError(f"only {res['total']} clips replayed (want >= {MIN_EVAL_CLIPS})")
    differ = sorted(set(ours) - set(same_final))
    if differ:
        raise AssertionError(f"final sequences differ from the JAX reference on {differ}")
    if forwards == 0 or launches["int8_matmul"] != INT8_LAUNCHES_PER_FORWARD * forwards \
            or launches["log_mel"] != forwards or launches["int4_matmul"] != 0:
        raise AssertionError("the corpus replay did not run the int8 and log-mel kernels "
                             "once per layer and forward")
    check_lattice_launches("streaming corpus", launches, lattice)
    return res, launches, sorted(forward_s)[len(forward_s) // 2] * 1e3


def streaming_tta(torch, np, kernels, rerank, validate_streaming, predict, recognizer,
                  plain_forward_ms: float) -> tuple[dict, dict]:
    """The streaming replay with the window TTA on (predict.STREAM_TTA set
    for the phase and put back after): every decodable v1 clip through
    validate_streaming on stream6-int8 in 300 ms chunks, counters zeroed
    just before and read just after. Each forward_batch call is recorded:
    its rows, and for a TTA cycle (two rows: the window and its 0.9x
    variant) the collapsed decode lengths [len(d0), len(d1)], whether the
    window is all zeros and its wall (host clock, ending in the ids' read).
    Gates: at least MIN_EVAL_CLIPS clips; 189 int8 and one log-mel launch a
    forward_batch call; one lattice launch a scorer chunk, the scorer's
    calls replayed on the plain lattice (lattice_report); each clip's
    emissions and final sequence equal to the JAX package's replay with its
    TTA on (jax_refs.STREAM_TTA_REF) but for named near ties, each printed:
    "silent" where the clip replayed again with its all-zero windows given
    the JAX package's features (jax_refs.jax_silent_features, ROADMAP C.11)
    gives the reference's decisions, "pick" where the replays part at a
    cycle one token from the other choice (jax_refs.tta_pick_near_tie).
    Returns (launches, lattice_report's numbers)."""
    from tilawa_tpu_torch.eval.jax_refs import (STREAM_TTA_REF, jax_silent_features, load_ref,
                                                tta_lengths, tta_parting, tta_pick_near_tie)

    def variants_kept(pairs) -> int:
        return sum(predict.keeps_variant(*pair) for pair in pairs)

    runtime = recognizer.runtime
    ref = load_ref(STREAM_TTA_REF)
    cycles: dict[str, dict] = {}
    clip: list[str] = []
    tta_s: list[float] = []
    calls = [0]

    def on_forward_batch(args, _kw, out, sec):
        calls[0] += 1
        if len(args[0]) == 2:
            row = cycles[clip[0]]
            if not np.any(args[0][0]):
                row["silent"].append(len(row["kept"]))
            row["kept"].append(tta_lengths(out[1], out[2], runtime.blank_id))
            tta_s.append(sec)

    def per_clip(sample, _audio):
        clip[:] = [sample["id"]]
        cycles[sample["id"]] = {"kept": [], "silent": []}
        return recognizer.transcribe_result

    def replay(ids=None) -> tuple[dict, dict]:
        with recorded_calls(runtime, "forward_batch", on_forward_batch):
            res = validate_streaming.run_validation(
                recognizer.transcribe_result, ids=ids, db=recognizer.db,
                token_store=recognizer.token_store, verbose=False, transcribe_factory=per_clip)
        return res, {r["id"]: {"predicted": _pairs(r["predicted"]),
                               "final_sequence": None if r["final_sequence"] is None
                               else _pairs(r["final_sequence"]),
                               "sequence_accuracy": r["sequence_accuracy"], **cycles[r["id"]]}
                     for r in res["per_sample"]}

    def decided_alike(i: str, row: dict) -> bool:
        return all(row[k] == ref[i][k] for k in ("predicted", "final_sequence"))

    saved = predict.STREAM_TTA
    predict.STREAM_TTA = True
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        runtime.forwards = 0
        t = time.perf_counter()
        with lattice_record(torch, rerank) as lattice:
            res, ours = replay()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, forwards, n_calls = dict(kernels.LAUNCHES), runtime.forwards, calls[0]
        tta_s = list(tta_s)     # the counted replay's, not the one below
        differ = sorted(i for i, r in ours.items() if not decided_alike(i, r))
        ties, again = {}, {}
        if differ:
            with jax_silent_features():
                again = replay(set(differ))[1]
    finally:
        predict.STREAM_TTA = saved
    for i in differ:
        pick = tta_pick_near_tie(ref[i], ours[i])
        if decided_alike(i, again[i]):
            ties[i] = f"silent: with JAX's features on its {len(ours[i]['silent'])} all-zero " \
                      f"windows the replay decides as JAX (TTA cycles part at " \
                      f"{tta_parting(ref[i], again[i])})"
        elif pick is not None:
            ties[i] = f"pick: the replays part at TTA cycle {pick[0]}, where JAX's " \
                      f"len(d1) - len(d0) = {pick[1]}"
    for i, r in ours.items():
        parting = tta_parting(ref[i], r)
        silent = parting is not None and parting in r["silent"] and parting in ref[i]["silent"]
        print(f"  {i:22s} seq_acc {r['sequence_accuracy']:.2f} (JAX "
              f"{ref[i]['sequence_accuracy']:.2f})  final {r['final_sequence']}"
              + ("" if i not in differ else f" vs JAX {ref[i]['final_sequence']}")
              + f"  TTA cycles {len(r['kept'])} (JAX {len(ref[i]['kept'])}), variant kept "
              f"{variants_kept(r['kept'])} (JAX {variants_kept(ref[i]['kept'])})"
              + ("" if parting is None else
                 f", cycles part at {parting}{' (silent window)' if silent else ''}"),
              flush=True)
    n_tta = sum(len(r["kept"]) for r in ours.values())
    n_kept = sum(variants_kept(r["kept"]) for r in ours.values())
    ref_tta = sum(len(ref[i]["kept"]) for i in ours)
    ref_kept = sum(variants_kept(ref[i]["kept"]) for i in ours)
    ref_acc = sum(ref[i]["sequence_accuracy"] for i in ours) / max(len(ours), 1)
    tta_p50 = sorted(tta_s)[len(tta_s) // 2] * 1e3 if tta_s else float("nan")
    print(f"  {res['total']} clips ({res['skipped']} skipped) in {wall:.1f} s: seq_acc "
          f"{res['sequence_accuracy']:.4f} (JAX {ref_acc:.4f} on these clips), viterbi "
          f"{res['viterbi_sequence_accuracy']:.4f}; {n_calls} forward_batch calls, {n_tta} of "
          f"them TTA cycles (JAX {ref_tta}), the variant kept in {n_kept} (JAX {ref_kept}); "
          f"{sum(len(r['silent']) for r in ours.values())} TTA windows all zeros; "
          f"{sum(tta_parting(ref[i], r) is None for i, r in ours.items())} clips with every "
          f"TTA cycle as JAX's", flush=True)
    print(f"  forward_batch of the two rows p50/p90 {_pcts(tta_s)} ms over {n_tta} "
          f"cycles (host clock, ending in the ids' read), {tta_p50 / plain_forward_ms:.3f}x "
          f"the plain forward's p50 {plain_forward_ms:.2f} ms in \"streaming corpus\"",
          flush=True)
    for i, why in ties.items():
        print(f"  near tie {i}: {why}", flush=True)
    print(f"  against {STREAM_TTA_REF.name}: emissions and final sequence equal on "
          f"{len(ours) - len(differ)} of {len(ours)}, {len(ties)} named near ties", flush=True)
    if res["total"] < MIN_EVAL_CLIPS:
        raise AssertionError(f"only {res['total']} clips replayed (want >= {MIN_EVAL_CLIPS})")
    if set(differ) - set(ties):
        raise AssertionError(f"decisions differ from the JAX TTA reference on "
                             f"{sorted(set(differ) - set(ties))}")
    if n_tta == 0 or forwards != n_calls \
            or launches["int8_matmul"] != INT8_LAUNCHES_PER_FORWARD * n_calls \
            or launches["log_mel"] != n_calls or launches["int4_matmul"] != 0:
        raise AssertionError(f"the TTA replay did not run 189 int8 and one log-mel launch a "
                             f"forward_batch call ({n_calls} calls, {forwards} forwards, "
                             f"{n_tta} TTA cycles)")
    check_lattice_launches("streaming tta", launches, lattice)
    return launches, lattice_report(torch, rerank, "streaming tta (fusion scoring)", lattice,
                                    res["total"])


@contextmanager
def recorded_calls(owner, attr: str, record):
    """owner.attr (a module's function or an object's method) with
    record(args, kwargs, result, wall seconds) called after each call while
    inside."""
    real = getattr(owner, attr)
    own = attr in vars(owner)

    def wrapped(*args, **kw):
        t = time.perf_counter()
        out = real(*args, **kw)
        record(args, kw, out, time.perf_counter() - t)
        return out

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, real)
        else:
            delattr(owner, attr)


def timed_calls(owner, attr: str, sink: list):
    """Wall seconds of every call of owner.attr while inside, into sink."""
    return recorded_calls(owner, attr, lambda _args, _kw, _out, sec: sink.append(sec))


def counted(torch, kernels, runtimes, fn):
    """fn() with the launch counters and the runtimes' forward counts
    zeroed just before and read just after: (result, launches, forwards)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    for rt in runtimes:
        rt.forwards = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), [rt.forwards for rt in runtimes]


def check_launches(what: str, launches: dict, runtimes, forwards: list[int]) -> None:
    """11·L + 2 int4 launches a forward of an L-block runtime, one log-mel
    a forward, no int8."""
    int4 = sum(int4_launches(rt.config.num_layers) * f for rt, f in zip(runtimes, forwards))
    depth = " + ".join(f"{f} x {int4_launches(rt.config.num_layers)} (L={rt.config.num_layers})"
                       for rt, f in zip(runtimes, forwards))
    print(f"  {what}: forwards {forwards}; launches {launches}; int4 expected {depth} = {int4}",
          flush=True)
    if sum(forwards) == 0 or launches["int4_matmul"] != int4 \
            or launches["log_mel"] != sum(forwards) or launches["int8_matmul"] != 0:
        raise AssertionError(f"{what} did not run 11·L + 2 int4 and one log-mel launch a forward")


def families(torch, kernels, rerank, get_experiment, load_manifest, run_experiment) -> dict:
    """The families that run on champion-int4: LM fusion over every v1
    sample (real acoustics, each clip the JAX record gets right right here),
    two-stage and the six pruned-ctc variants over CLIPS (no error), each
    with 11·L + 2 int4 launches a forward of its L-block runtimes and one
    lattice launch a scorer chunk (lattice_report for two-stage and
    pruned); heldout raises FileNotFoundError where its bundle is not in
    the copy. Returns ({path: (int4, log-mel, lattice launches)},
    {path: lattice_report's numbers})."""
    samples, corpus_dir = load_manifest("v1")
    clip_samples = [s for s in samples if s["file"] in CLIPS]
    out, lattices = {}, {}

    exp = get_experiment(LM_FUSION, DEVICE)
    if exp.acoustics != "real" or exp.real is None:
        raise AssertionError(f"{LM_FUSION} runs on {exp.acoustics} acoustics, not the champion")
    with lattice_record(torch, rerank, replay=False) as lattice:
        res, launches, fw = counted(torch, kernels, [exp.real.runtime],
                                    lambda: run_experiment(LM_FUSION, exp, samples, corpus_dir))
    check_launches(LM_FUSION, launches, [exp.real.runtime], fw)
    check_lattice_launches(LM_FUSION, launches, lattice)
    out[LM_FUSION] = (launches["int4_matmul"], launches["log_mel"], launches["ctc_lattice"])
    errors = [d["id"] for d in res["dispositions"] if d["status"] == "error"]
    recorded = {r["id"]: r for r in json.loads(JAX_LM_FUSION_RUN.read_text())[0]["per_sample"]}
    ours = {r["id"]: r for r in res["per_sample"]}
    right = [i for i in ours if recorded[i]["sequence_accuracy"] == 1.0]
    missed = [i for i in right if ours[i]["sequence_accuracy"] != 1.0]
    same = [i for i in ours if _verses(ours[i]["predicted"]) == _verses(recorded[i]["predicted"])]
    print(f"  {LM_FUSION}: N={res['total']} recall {res['recall']:.4f} seq_acc "
          f"{res['sequence_accuracy']:.4f} p50 {res['p50_latency'] * 1e3:.2f} ms ({res['acoustics']} "
          f"acoustics); {len(same)} of {len(ours)} clips emit the verses of the JAX record "
          f"{JAX_LM_FUSION_RUN.name} (not {[i for i in ours if i not in same]}; ROADMAP C.9: "
          f"multi_114_001_006's greedy ids are a near tie); it gets {len(right)} of them right, "
          f"the port misses "
          f"{missed}; wrong here: "
          f"{[i for i, r in ours.items() if r['sequence_accuracy'] != 1.0]}", flush=True)
    if errors or missed:
        raise AssertionError(f"{LM_FUSION}: errors {errors}; misses the record's right clips "
                             f"{missed}")

    def clips_run(name, exp, runtimes):
        with lattice_record(torch, rerank) as lattice:
            res, launches, fw = counted(torch, kernels, runtimes, lambda: run_experiment(
                name, exp, clip_samples, corpus_dir))
        errors = [d for d in res["dispositions"] if d["status"] == "error"]
        print(f"  {name:28s} N={res['total']} recall {res['recall']:.4f} seq_acc "
              f"{res['sequence_accuracy']:.4f} p50 {res['p50_latency'] * 1e3:.2f} ms", flush=True)
        check_launches(name, launches, runtimes, fw)
        check_lattice_launches(name, launches, lattice)
        lattices[name] = lattice_report(torch, rerank, name, lattice, res["total"] + 1)
        if errors or res["total"] != len(CLIPS):
            raise AssertionError(f"{name}: {len(errors)} errors, {res['total']} clips scored")
        out[name] = (launches["int4_matmul"], launches["log_mel"], launches["ctc_lattice"])

    two = get_experiment("two-stage", DEVICE)
    stage1, stage2 = two.stages
    clips_run("two-stage", two, [stage1.runtime, stage2.runtime])
    pruned = get_experiment("pruned-ctc", DEVICE)
    for variant in pruned.list_models():
        pruned.set_model(variant)
        clips_run(f"pruned-ctc/{variant}", pruned, [pruned.runtime])

    from tilawa_tpu_torch.eval.experiments import _heldout_checkpoint

    if _heldout_checkpoint() is None:
        try:
            get_experiment("heldout", DEVICE)
        except FileNotFoundError as e:
            print(f"  heldout: raises FileNotFoundError here ({e}); not run", flush=True)
        else:
            raise AssertionError("heldout built a model without its bundle")
    else:
        print(f"  heldout: its bundle {_heldout_checkpoint()} is in this copy; not run",
              flush=True)
    return out, lattices


def _pairs(entries) -> list[list[int]]:
    return [list(v) for v in _verses(entries)]


@contextmanager
def lattice_record(torch, rerank, keep: int = 0, replay: bool = True):
    """While inside, every rerank.score_token_lists call (its wall seconds,
    arguments and scores; with `replay`, its log-probs cloned, for
    lattice_report to replay) and every call of the scorer under it
    (rerank.ctc_forward_scores: one a `_score_feasible` chunk, which must
    launch the lattice kernel once), the first `keep` of those with their
    inputs and scores cloned. Yields {"calls", "chunks", "kept"}."""
    rec = {"calls": [], "chunks": 0, "kept": []}

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def on_call(args, kw, out, sec):
        lp, t_valid, lists = args[:3]
        blank = kw.get("blank_id", args[3] if len(args) > 3 else rerank.BLANK_ID)
        rec["calls"].append({"sec": sec, "lp": clone(lp) if replay else None,
                             "t_valid": int(t_valid), "lists": lists, "blank": blank,
                             "scores": out})

    def on_chunk(args, _kw, out, _sec):
        rec["chunks"] += 1
        if len(rec["kept"]) < keep:
            rec["kept"].append((tuple(clone(a) for a in args), out.clone()))

    with recorded_calls(rerank, "score_token_lists", on_call), \
            recorded_calls(rerank, "ctc_forward_scores", on_chunk):
        yield rec


def check_lattice_launches(what: str, launches: dict, rec: dict, required: bool = True) -> None:
    """One lattice launch a scorer chunk (a chunk scored on the CPU launches
    none, so a caller that hands the scorer host log-probs fails here), and
    at least one chunk where the path must rerank."""
    print(f"  {what}: {len(rec['calls'])} lattice calls in {rec['chunks']} scorer chunks; "
          f"{launches['ctc_lattice']} ctc_lattice launches", flush=True)
    if launches["ctc_lattice"] != rec["chunks"] or required and rec["chunks"] == 0:
        raise AssertionError(f"{what}: {launches['ctc_lattice']} lattice launches for "
                             f"{rec['chunks']} scorer chunks")


def lattice_report(torch, rerank, what: str, rec: dict, predicts: int) -> dict:
    """Per-call p50 / p90 and ms per clip (`predicts`: the clips, a runner's
    warm-up included) of the recorded calls on the kernel path, beside the
    plain path's: each call replayed here at its own log-probs and lists
    with the plain scorer (score_token_lists(plain=True), chunked under the
    gather cap), its scores held to the kernel's (lattice_gate). Host
    clock, both ending in the scores' host read."""
    calls = rec["calls"]
    if not calls:
        print(f"  {what}: no lattice call", flush=True)
        return {"calls": 0, "chunks": rec["chunks"]}
    plain, err = [], 0.0
    for call in calls:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref = rerank.score_token_lists(call["lp"], call["t_valid"], call["lists"],
                                       blank_id=call["blank"], plain=True)
        plain.append(time.perf_counter() - t)
        err = max(err, lattice_gate(torch, f"{what} lattice call", call["scores"], ref))

    def pcts(secs):
        v = sorted(secs)
        return (v[len(v) // 2] * 1e3, v[int(0.9 * (len(v) - 1))] * 1e3,
                sum(v) * 1e3 / max(predicts, 1))

    kernel = pcts([c["sec"] for c in calls])
    base = pcts(plain)
    out = {"calls": len(calls), "chunks": rec["chunks"],
           **dict(zip(("p50_ms", "p90_ms", "ms_per_clip"), kernel)),
           **dict(zip(("plain_p50_ms", "plain_p90_ms", "plain_ms_per_clip"), base)),
           "max_abs_err": err,
           "candidates_p50": sorted(len(c["lists"]) for c in calls)[len(calls) // 2],
           "max_L": max(max((len(x) for x in c["lists"]), default=0) for c in calls),
           "max_T": max(c["t_valid"] for c in calls)}
    print(f"  {what}: lattice (rerank.score_token_lists) {out['calls']} calls, "
          f"{out['chunks']} chunks: kernel p50 {kernel[0]:.2f} ms, p90 {kernel[1]:.2f} ms, "
          f"{kernel[2]:.2f} ms per clip; plain (the same calls replayed) p50 {base[0]:.2f} ms, "
          f"p90 {base[1]:.2f} ms, {base[2]:.2f} ms per clip; scores within {err:.3g}; "
          f"candidates p50 {out['candidates_p50']}, longest L {out['max_L']}, t_valid up to "
          f"{out['max_T']}", flush=True)
    return out


def runner_decisions(torch, kernels, name: str, exp, runtime, runtimes, samples, corpus_dir,
                     run_experiment) -> tuple[dict, dict, list, dict]:
    """`exp` through the port's runner over `samples` (counters zeroed just
    before, read just after), each predict() recorded with every encoder row
    it forwards on `runtime` (forward_batch, log_probs_batch; None: no
    model). Returns (runner result, launches, forwards, {clip id:
    decision_row})."""
    from tilawa_tpu_torch.eval.jax_refs import decision_row

    raw: dict[str, tuple] = {}
    rows_of: list = []

    def on_predict(args, _kw, out, _sec):
        raw[Path(args[0]).stem] = (out, list(rows_of))
        rows_of.clear()

    def on_forward(args, _kw, out, _sec):   # (lp [B, T, V], lens [B], ...)
        lps = out[0].float().cpu().numpy() if torch.is_tensor(out[0]) else out[0]
        lens = out[1].cpu().numpy() if torch.is_tensor(out[1]) else out[1]
        rows_of.extend((lps[i], int(lens[i])) for i in range(len(args[0])))

    with contextlib.ExitStack() as stack:
        stack.enter_context(recorded_calls(exp, "predict", on_predict))
        for attr in ("forward_batch", "log_probs_batch") if runtime is not None else ():
            stack.enter_context(recorded_calls(runtime, attr, on_forward))
        res, launches, fw = counted(torch, kernels, runtimes, lambda: run_experiment(
            name, exp, samples, corpus_dir))
    files = {s["id"]: Path(s["file"]).stem for s in samples}
    rows = {r["id"]: decision_row(raw[files[r["id"]]][0], r["predicted"], raw[files[r["id"]]][1])
            for r in res["per_sample"]}
    return res, launches, fw, rows


def compare_decisions(what: str, ours: dict, ref: dict) -> list:
    """Each clip's verses against the JAX reference's. A clip that differs
    is named a near tie where the port's pick is within the packages' score
    difference of the reference's best and that leads by less (C.6), or
    where the greedy ids of its forwarded rows differ from the reference's
    only at frames whose top-two gap is under jax_refs.LP_TOL (C.9); any
    other difference fails. Returns the near ties."""
    from tilawa_tpu_torch.eval.jax_refs import LP_TOL, flipped_frames, greedy_near_tie, near_tie

    differ, ties = [], []
    for i, row in ours.items():
        if i not in ref:
            differ.append((i, "not in the reference"))
        elif row["predicted"] != ref[i]["predicted"]:
            score_tie, greedy_tie = near_tie(ref[i], row), greedy_near_tie(ref[i], row)
            if score_tie is None and greedy_tie is None:
                differ.append((i, row["predicted"], ref[i]["predicted"]))
                continue
            ties.append(i)
            how = (f"JAX's margin {score_tie:.4g} under the packages' score difference"
                   if score_tie is not None else
                   f"greedy ids differ at {len(flipped_frames(ref[i], row))} frames, JAX's "
                   f"top-two gap there at most {greedy_tie:.4g} < {LP_TOL}")
            print(f"    {what} near tie {i}: {row['predicted']} (JAX {ref[i]['predicted']}); "
                  f"{how}", flush=True)
    same_text = sum(row["transcript"] == ref.get(i, {}).get("transcript")
                    for i, row in ours.items())
    print(f"  {what}: verses equal to the JAX reference on {len(ours) - len(differ) - len(ties)} "
          f"of {len(ours)} clips, transcripts on {same_text}; near ties {ties}; other "
          f"differences {differ}", flush=True)
    if differ:
        raise AssertionError(f"{what}: verses differ from the JAX reference on {differ}")
    return ties


def phoneme_run(torch, kernels, rerank, exp, runtimes, section: str, load_manifest,
                run_experiment) -> tuple[dict, dict, list, dict]:
    """fastconformer-phoneme `exp` through the port's runner over every v1
    sample, TILAWA_PHONEME_RERANK set for the *_rerank sections of the JAX
    reference file, the lattice's calls recorded; its decisions held to that
    section's (compare_decisions); one lattice launch a scorer chunk, at
    least one chunk where it reranks, none where it does not. Returns
    (runner result, launches, forwards, lattice_report's numbers)."""
    from tilawa_tpu_torch.eval.jax_refs import PHONEME_REF, load_ref

    samples, corpus_dir = load_manifest("v1")
    reranks = section.endswith("_rerank")
    os.environ["TILAWA_PHONEME_RERANK"] = "1" if reranks else ""
    try:
        with lattice_record(torch, rerank) as lattice:
            res, launches, fw, ours = runner_decisions(
                torch, kernels, PHONEME, exp, runtimes[0] if runtimes else None, runtimes,
                samples, corpus_dir, run_experiment)
    finally:
        os.environ.pop("TILAWA_PHONEME_RERANK", None)
    errors = [d["id"] for d in res["dispositions"] if d["status"] == "error"]
    print(f"  {PHONEME} [{section}, {res['acoustics']} acoustics]: N={res['total']} recall "
          f"{res['recall']:.4f} seq_acc {res['sequence_accuracy']:.4f} p50 "
          f"{res['p50_latency'] * 1e3:.2f} ms; launches {launches}, forwards {fw}", flush=True)
    compare_decisions(f"{PHONEME} [{section}]", ours, load_ref(PHONEME_REF, section))
    check_lattice_launches(f"{PHONEME} [{section}]", launches, lattice, required=reranks)
    if not reranks and lattice["chunks"]:
        raise AssertionError(f"{PHONEME} [{section}] scored a lattice with the rerank off")
    lat = lattice_report(torch, rerank, f"{PHONEME} [{section}]", lattice, res["total"] + 1)
    lat["launches"] = launches["ctc_lattice"]
    if errors or not ours:
        raise AssertionError(f"{PHONEME} [{section}]: errors {errors}, {len(ours)} clips")
    return res, launches, fw, lat


def phoneme_oracle(torch, kernels, rerank, load_manifest, run_experiment) -> dict:
    """fastconformer-phoneme on oracle acoustics (rendered on the host from
    seed 0, as the JAX package renders them) over every v1 manifest row,
    the CTC rerank off and on (its lattice on the card): decisions equal to
    the JAX package's on the CPU, no kernel launched but the lattice's (one
    a scorer chunk of the rerank)."""
    from tilawa_tpu_torch.eval.experiments import PhonemeExperiment

    out = {}
    for section in ("oracle", "oracle_rerank"):
        exp = PhonemeExperiment(DEVICE, oracle=True)
        res, launches, _fw, out[section] = phoneme_run(
            torch, kernels, rerank, exp, [], section, load_manifest, run_experiment)
        if res["acoustics"] != "oracle" or any(
                n for name, n in launches.items() if name != "ctc_lattice"):
            raise AssertionError(f"the oracle phoneme run is labelled {res['acoustics']} or "
                                 f"launched {launches}")
    return out


def phoneme_train_phase(torch, np, kernels, init: Path, ckpt_dir: Path, steps: int,
                        keeps_head: bool) -> dict:
    """train.phoneme at full width from `init` (dequantized) over v1 phoneme
    targets, `steps` steps, in ckpt_dir, under sync_census: per step the
    bucket, loss, step ms (CUDA events, as in "train") and launches. Asserts
    finite losses, one log-mel launch a step and no quantized one, no
    synchronizing call of the port's own code in steps 2..; the head it
    starts from is `init`'s own dequantized head (keeps_head) or a fresh
    one ([512, 70] lecun normal, bias 0); the last checkpoint loads in
    EncoderRuntime and gives finite [T, 70] log-probs."""
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.phoneme import train_phoneme
    from tilawa_tpu_torch.train.quantize import dequantize_variables

    steps_log: list[dict] = []
    start = torch.cuda.Event(enable_timing=True)

    def callback(i, state, batch, loss):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        resume = torch.cuda.Event(enable_timing=True)
        resume.record()
        steps_log.append({"i": i, "shape": batch[0].shape, "loss": loss, "end": end,
                          "resume": resume, "launches": launches, "warnings": len(seen)})

    torch.cuda.synchronize()
    kernels.reset_launches()
    with sync_census(torch) as seen:
        start.record()
        train_phoneme(init=init, checkpoint_dir=ckpt_dir, steps=steps, corpora=("v1",),
                      seed=SEED, device=DEVICE, checkpoint_every=steps + 1, callback=callback)
        torch.cuda.synchronize()
    timed_steps(steps_log, start)
    for st in steps_log:
        b, n = st["shape"]
        print(f"  step {st['i']}: {b} x {n / 16000:g} s, loss {float(st['loss']):.4f}, "
              f"{st['ms']:.2f} ms, launches {st['launches']}", flush=True)
    syncs = check_syncs(steps_log, seen, 2, f"train.phoneme from {init.name}")
    if not all(np.isfinite(float(st["loss"])) for st in steps_log):
        raise AssertionError("a phoneme training loss is not finite")
    bad = [st["i"] for st in steps_log if st["launches"] != {
        "int4_matmul": 0, "log_mel": 1, "int8_matmul": 0, "ctc_lattice": 0,
        "ctc_loss": CTC_LOSS_LAUNCHES_PER_STEP}]
    if bad:
        raise AssertionError(f"steps {bad}: want 1 log-mel, {CTC_LOSS_LAUNCHES_PER_STEP} "
                             "ctc_loss and no quantized launch a step")

    cfg0, start_vars = load_variables(ckpt_dir / "init")
    head = start_vars["params"]["ctc_head"]
    if cfg0.num_classes != 70 or head["kernel"].shape != (512, 70):
        raise AssertionError(f"the trained head is {head['kernel'].shape}, vocab {cfg0.vocab_size}")
    if keeps_head:
        kept = dequantize_variables(load_variables(init)[1])["params"]["ctc_head"]
        if not (np.array_equal(head["kernel"], kept["kernel"])
                and np.array_equal(head["bias"], kept["bias"])):
            raise AssertionError(f"continuation from {init} did not keep its trained head")
        what = f"kept {init.name}'s trained head"
    else:
        ratio = float(head["kernel"].std() * np.sqrt(512))
        if abs(ratio - 1) > HEAD_STD_BAND or head["bias"].any():
            raise AssertionError(f"fresh head: std x sqrt(512) {ratio}, bias {head['bias'][:4]}")
        what = f"fresh head, std x sqrt(512) {ratio:.4f}, bias 0"
    cfg, variables = load_variables(ckpt_dir / f"step_{steps:06d}")
    rt = EncoderRuntime(cfg, variables, device=DEVICE)
    lp, t = rt.log_probs(load_audio(CORPUS / CLIPS[1]))
    print(f"  {what}; step_{steps:06d} in EncoderRuntime: log-probs {tuple(lp.shape)}, "
          f"t_valid {t}", flush=True)
    if lp.shape[-1] != 70 or t <= 0 or not np.isfinite(lp[:t]).all():
        raise AssertionError(f"the trained checkpoint gives log-probs {lp.shape}, t {t}")
    timed = steps_log[1:]
    return {"step_ms": sorted(st["ms"] for st in timed)[len(timed) // 2],
            "losses": [float(st["loss"]) for st in steps_log], "sync_sites": syncs,
            "log_mel_launches": sum(st["launches"]["log_mel"] for st in steps_log),
            "ctc_loss_launches": sum(st["launches"]["ctc_loss"] for st in steps_log)}


def harnesses(torch, np, kernels, runtime, validate_streaming, load_audio, manifest,
              eval_res: dict, stream_res: dict, tmp: Path) -> dict:
    """The diagnostic harnesses: the context sweep over CLIPS on the
    champion (11·L + 2 int4 and one log-mel launch a forward; every row of
    a sweep's batched forward bitwise equal to the same row forwarded alone
    at the same bucket), run_stability of MAIN_EXPERIMENT (no flaky sample,
    every clip a stable pass), tracker_oracle over v1 (no kernel launched),
    and analyze / compare over this run's eval and streaming results.
    Returns {path: (int4, log-mel, lattice launches)}."""
    from tilawa_tpu_torch.data.quran import QuranDB
    from tilawa_tpu_torch.data.token_store import TokenStore
    from tilawa_tpu_torch.data.tokenizer import SentencePieceBPE
    from tilawa_tpu_torch.device import upload
    from tilawa_tpu_torch.eval import context_sweep, tracker_oracle
    from tilawa_tpu_torch.eval.analyze import analyze_results
    from tilawa_tpu_torch.eval.compare import compare_results
    from tilawa_tpu_torch.eval.stability import run_stability
    from tilawa_tpu_torch.pipeline.runtime import bucket_length

    from tilawa_tpu_torch.eval.jax_refs import SWEEP_REF, load_ref

    ids = {manifest[c]["id"] for c in CLIPS}
    out = {}
    moved: list[tuple] = []
    jax_sweep = load_ref(SWEEP_REF, "per_row")
    sweep, launches, fw = counted(torch, kernels, [runtime], lambda: context_sweep.run_sweep(
        runtime, ids=ids, verbose=False))
    check_launches("context sweep", launches, [runtime], fw)
    out["context-sweep"] = (launches["int4_matmul"], launches["log_mel"], launches["ctc_lattice"])
    for table, rows in sweep.items():
        print(f"  {table}: " + ", ".join(f"{k} {v['value']} (n={v['n']})" for k, v in rows.items()),
              flush=True)
    rows_checked, own_bucket_same, own_bucket_rows = 0, 0, 0
    for clip in CLIPS:
        keys, pieces = context_sweep.sweep_pieces(load_audio(CORPUS / clip))
        lps, t_valids = runtime.log_probs_batch(pieces)
        n_pad = bucket_length(max(len(p) for p in pieces))
        for i, piece in enumerate(pieces):
            alone = np.zeros((1, n_pad), np.float32)
            alone[0, : len(piece)] = piece
            lp1, t1 = runtime._apply(upload(alone, runtime.device),
                                     upload(np.array([len(piece)], np.int32), runtime.device))
            lp1, t = lp1[0].cpu().numpy(), int(t_valids[i])
            if int(t1[0]) != t or not np.array_equal(lps[i, :t].view(np.int32),
                                                     lp1[:t].view(np.int32)):
                raise AssertionError(f"context sweep {clip} row {keys[i]}: B={len(pieces)} row "
                                     f"differs from the row alone at N={n_pad}")
            rows_checked += 1
            if n_pad != bucket_length(len(piece)):
                own, t_own = runtime.log_probs(piece)
                own_bucket_rows += 1
                ids_own, ids_pad = own[:t].argmax(-1), lps[i, :t].argmax(-1)
                if t_own == t and np.array_equal(ids_own, ids_pad):
                    own_bucket_same += 1
                    continue
                flips = np.flatnonzero(ids_own != ids_pad) if t_own == t else np.arange(t)
                # each flipped frame's top-two gap, the smaller of the two buckets'
                gap = float(np.minimum(*(np.diff(np.sort(x[flips], axis=-1)[:, -2:], axis=-1)
                                         for x in (own[:t], lps[i, :t]))).max())
                row = f"{clip}@{keys[i]}"
                jax_delta = jax_sweep.get(row, {}).get("max_abs_delta", 0.0)
                moved.append((row, piece, bucket_length(len(piece)), n_pad, gap, jax_delta))
                delta = float(np.abs(own[:t] - lps[i, :t]).max())
                print(f"  sweep row {row} s: greedy ids at its own bucket "
                      f"{bucket_length(len(piece))} differ from those at {n_pad} on {len(flips)} "
                      f"of {t} frames {flips.tolist()[:8]}; top-two gap there at most "
                      f"{gap:.4g}; max|Δ log-prob| {delta:.4g} "
                      f"(JAX on the CPU: {jax_delta:.4g}, frames moved "
                      f"{jax_sweep.get(row, {}).get('moved_frames')})", flush=True)
    jax_moved = sorted(r for r, v in jax_sweep.items() if v["moved_frames"])
    print(f"  context sweep: {rows_checked} rows of {len(CLIPS)} batched forwards (B "
          f"{sorted({b for b, _n, _t in sweep_shapes()})}) bitwise equal to each row forwarded "
          f"alone at the same bucket; at the row's own smaller bucket {own_bucket_same} of "
          f"{own_bucket_rows} give the same greedy ids (moved: {[m[0] for m in moved]}; the "
          f"JAX package's own on the CPU move on {jax_moved} of {len(jax_sweep)})", flush=True)
    for row, piece, n_own, n_pad, _gap, _d in moved:
        print(f"  {row} s, bucket {n_own} vs {n_pad}:", flush=True)
        bucket_variance(torch, runtime, piece, n_own, n_pad)
    # the reference's ids depend on the bucket too (ROADMAP C.7): a row may move
    # only at frames whose top-two gap is under what the padding moves JAX's
    # log-probs by on that row
    beyond = [(row, gap, d) for row, _p, _n, _m, gap, d in moved if not gap < d]
    if own_bucket_rows != len(jax_sweep) or beyond:
        raise AssertionError(f"sweep rows at their own bucket: {own_bucket_rows} (JAX reference "
                             f"{len(jax_sweep)}); moved beyond the reference's own bucket "
                             f"dependence: {beyond}")

    report, launches, fw = counted(torch, kernels, [], lambda: run_stability(
        MAIN_EXPERIMENT, repeats=STABILITY_REPEATS, ids=ids, device=DEVICE))
    out["stability"] = (launches["int4_matmul"], launches["log_mel"], launches["ctc_lattice"])
    print(f"  stability {MAIN_EXPERIMENT} x{STABILITY_REPEATS} over {report['samples']} clips: "
          f"stable_pass {report['stable_pass']}, flaky {report['flaky']}, stable_fail "
          f"{report['stable_fail']}, median seq_acc {report['median_seq_acc']:.4f}; launches "
          f"{launches}", flush=True)
    if report["flaky"] or report["stable_pass"] != len(CLIPS):
        raise AssertionError(f"stability: {report['per_sample']}")

    def oracle_replay():
        return validate_streaming.run_validation(
            None, db=QuranDB(), token_store=TokenStore.load_default(), verbose=False,
            transcribe_factory=tracker_oracle.make_factory("v1", SentencePieceBPE.load_default()),
            name="tracker-oracle-drop")

    t = time.perf_counter()
    ceiling, launches, _fw = counted(torch, kernels, [], oracle_replay)
    print(f"  tracker_oracle (no model, host only) over v1: policy ceiling seq_acc "
          f"{ceiling['sequence_accuracy']:.4f}, viterbi {ceiling['viterbi_sequence_accuracy']:.4f}, "
          f"recall {ceiling['recall']:.4f} over {ceiling['total']} clips ({ceiling['skipped']} "
          f"skipped) in {time.perf_counter() - t:.1f} s; launches {launches}", flush=True)
    if ceiling["total"] == 0 or any(launches.values()):
        raise AssertionError("tracker_oracle replayed no clip or launched a kernel")

    files = {}
    for name, res in (("eval", eval_res), ("streaming", stream_res)):
        files[name] = tmp / f"{name}.json"
        files[name].write_text(json.dumps([res], default=str))
    loaded = {k: json.loads(v.read_text()) for k, v in files.items()}
    tax = {name: analyze_results(data) for name, data in loaded.items()}
    for name, t in tax.items():
        print(f"  analyze {name}: {t['total']} samples {t['counts']}", flush=True)
    cmp = compare_results(loaded["eval"], loaded["streaming"])
    print(f"  compare eval vs streaming: {cmp['common_samples']} common samples {cmp['counts']}; "
          f"streaming_loss {cmp['classes']['streaming_loss']}", flush=True)
    # the eval phase is exact on every clip, so every streaming miss is a streaming loss
    common = {r["id"] for r in eval_res["per_sample"]} & {r["id"] for r in stream_res["per_sample"]}
    stream_misses = {f["id"] for f in tax["streaming"]["failures"]} & common
    if tax["eval"]["counts"] != {"exact": eval_res["total"]} \
            or cmp["common_samples"] != len(common) \
            or set(cmp["classes"]["streaming_loss"]) != stream_misses:
        raise AssertionError("analyze/compare disagree with this run's eval and streaming rows")
    return out


def _md_inputs():
    """The "multi-device" phase's model and batch: the dequantized
    champion's config with finetune's dropout and SpecAugment, its
    variables, and train_vs_plain's v1 batch."""
    from tilawa_tpu_torch.train.checkpoint import load_variables
    from tilawa_tpu_torch.train.data import bucketed_corpus_batches
    from tilawa_tpu_torch.train.quantize import dequantize_variables, dequantized_config

    cfg, variables = load_variables(CHAMPION)
    config = dequantized_config(cfg, dropout=0.1, sa_freq_masks=2, sa_time_masks=10,
                                sa_time_frac=0.05)
    batch = next(bucketed_corpus_batches(("v1",), seed=SEED + 1, augment=False))
    return config, dequantize_variables(variables), batch


def _md_deltas(x: dict, y: dict) -> dict:
    """Two runs' per-step |Δ loss| and largest per-leaf max|Δg|/max|g|
    (leaves under GRAD_FLOOR left out, as in train_vs_plain), and after
    the steps the largest per-leaf max|Δp|/max|p| and max|Δ| of the
    BatchNorm stats."""
    def is_stat(k):
        return k.endswith((".mean", ".var"))

    params = {k: v for k, v in x["full"].items() if not is_stat(k)}
    grads = [_leaf_delta(gx, gy) for gx, gy in zip(x["grads"], y["grads"])]
    return {"loss": [abs(a - b) for a, b in zip(x["losses"], y["losses"])],
            "grad": [g for g, _leaf in grads], "grad_leaf": [leaf for _g, leaf in grads],
            "params": _leaf_delta(params, y["full"], None)[0],
            "stats": max(float((v - y["full"][k]).abs().max())
                         for k, v in x["full"].items() if is_stat(k))}


def multi_device_rank(rank: int, world_size: int, dev, layouts) -> dict:
    """One rank of the "multi-device" phase (NCCL, one card a rank): the
    dequantized champion at full width (_md_inputs) on one v1 batch, MD_STEPS
    steps a run from the same variables with the same step generators.
    Unsharded on this rank's card: the recipe (bf16, dropout, SpecAugment,
    live BatchNorm) twice, whose difference is the floor of a one-rank
    mesh; the recipe in f32 (no TF32) and in f64 (matmuls, convolutions
    and attention in f64; the norms, the head's log-softmax and the CTC
    loss stay f32, as in every dtype): the f32 step's distance from the
    f64 one is the rounding that any order of f32 sums carries, the floor
    of a mesh that splits sums. Then for each (data, model) layout over the world's
    ranks the sharded recipe in bf16 and in f32, with per step the loss,
    the reduced gradient (gathered, before the clip) and the launches; the
    step ms of the bf16 paths (CUDA events, in turns), one step of each
    under torch.profiler, and the sharded inference and rerank dispatch of
    the batch's first 6 transcripts against the unsharded model holding
    the same variables, in bf16 and f32. Every rank computes every number."""
    import numpy as np
    import torch

    from tilawa_tpu_torch.models.convert import load_into
    from tilawa_tpu_torch.models.fastconformer import FastConformerCTC
    from tilawa_tpu_torch.ops import kernels
    from tilawa_tpu_torch.parallel.dryrun import recognize_scores
    from tilawa_tpu_torch.parallel.mesh import make_mesh
    from tilawa_tpu_torch.parallel.sharding import shard_variables
    from tilawa_tpu_torch.train.train import (TrainState, make_optimizer, make_train_step,
                                              step_generator)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False   # f32 convolutions in f32 (bf16 unaffected)
    config, variables, batch = _md_inputs()
    f32 = dataclasses.replace(config, dtype=torch.float32)

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()

    def run_steps(cfg, rows, mesh=None, census=False) -> dict:
        """MD_STEPS steps; with `census`, the steps (each ending in its
        loss's read) under sync_census, their sync sites per step."""
        model = load_into(FastConformerCTC(cfg), variables).to(dev)
        if mesh is not None:
            shard_variables(model, mesh)
        opt = make_optimizer(model.parameters(), lr=3e-4, warmup_steps=1, total_steps=10)
        step_fn = make_train_step(cfg.blank_id)
        names = {id(p): n for n, p in model.named_parameters()}
        update, grads = opt.step, []

        def step():
            grads.append({names[id(p)]: full(p.grad) for p in opt.params})
            update()

        opt.step = step
        state, losses, launches, syncs = TrainState(model, opt), [], [], []
        with sync_census(torch) if census else contextlib.nullcontext([]) as seen:
            for i in range(MD_STEPS):
                kernels.reset_launches()
                first = len(seen)
                losses.append(float(step_fn(state, rows, step_generator(SEED, i, dev))))
                launches.append(dict(kernels.LAUNCHES))
                syncs.append(sync_sites(seen, first, len(seen)))
        opt.step = update
        return {"state": state, "step_fn": step_fn, "losses": losses, "grads": grads,
                "launches": launches, "sync_sites": syncs,
                "full": {k: full(v) for k, v in model.state_dict().items()}}

    def scores(run, cfg) -> dict:
        """The sharded forward + rerank of 6 transcripts against the
        unsharded model with the same variables."""
        model = run["state"].model
        cands, cand_lens = np.asarray(batch[2][:6]), np.asarray(batch[3][:6])
        kernels.reset_launches()
        got = recognize_scores(model, batch[0], batch[1], cands, cand_lens)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        ref_model = FastConformerCTC(cfg).to(dev)
        ref_model.load_state_dict({k: full(v) for k, v in model.state_dict().items()})
        ref = recognize_scores(ref_model, batch[0], batch[1], cands, cand_lens)
        finite = torch.isfinite(ref)
        return {"launches": launches, "shape": tuple(got.shape),
                "same_inf": bool(torch.equal(finite, torch.isfinite(got))),
                "finite": int(finite.sum()),
                "max_abs": float(ref[finite].abs().max()) if finite.any() else 0.0,
                "max_err": float((got[finite] - ref[finite]).abs().max())
                if finite.any() else 0.0,
                "bitwise": bool(torch.equal(got, ref))}

    def replay(run) -> float:
        """The run's own reduced gradients through a single-process
        optimizer from the same variables: the largest per-leaf
        max|Δp|/max|p| against the run's parameters."""
        model = load_into(FastConformerCTC(f32), variables).to(dev)
        opt = make_optimizer(model.parameters(), lr=3e-4, warmup_steps=1, total_steps=10)
        params = dict(model.named_parameters())
        for grads in run["grads"]:
            for name, p in params.items():
                p.grad = grads[name].clone()
            opt.step()
        return _leaf_delta({n: p.detach() for n, p in params.items()}, run["full"], None)[0]

    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def profiled(run) -> dict:
        """One more step under torch.profiler: the host's self time, the
        device's busy time and the host ops that take the most."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run["step_fn"](run["state"], batch,
                           step_generator(SEED, MD_STEPS + MD_TIMED_STEPS, dev))
            torch.cuda.synchronize()
        stats = prof.key_averages()
        top = sorted(stats, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
        return {"host_self_ms": sum(e.self_cpu_time_total for e in stats) / 1e3,
                "device_busy_ms": sum(device_us(e) for e in stats) / 1e3,
                "top_host_ops": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                                 for e in top]}

    def timed(plain, sharded) -> dict:
        """MD_TIMED_STEPS steps a path, the paths in turns: CUDA events
        around each step, and the host clock from a synchronized start to a
        synchronized end."""
        events = {"plain": [], "sharded": []}
        host = {"plain": [], "sharded": []}
        for i in range(MD_TIMED_STEPS):
            order = (("plain", plain), ("sharded", sharded))
            for name, run in order if i % 2 == 0 else order[::-1]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                gen = step_generator(SEED, MD_STEPS + i, dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                start.record()
                run["step_fn"](run["state"], batch, gen)
                end.record()
                torch.cuda.synchronize()
                host[name].append((time.perf_counter() - t) * 1e3)
                events[name].append((start, end))
        return {**{f"{name}_step_ms": [s.elapsed_time(e) for s, e in evs]
                   for name, evs in events.items()},
                **{f"{name}_host_ms": ms for name, ms in host.items()}}

    print(f"  rank {rank} of {world_size}: batch {batch[0].shape[0]} x "
          f"{batch[0].shape[1] / 16000:g} s", flush=True)
    plain, again = run_steps(config, batch), run_steps(config, batch)
    del again["state"]
    out = {"plain_losses": plain["losses"], "floor": _md_deltas(again, plain)}
    plain32 = run_steps(f32, batch)
    ref64 = run_steps(dataclasses.replace(f32, dtype=torch.float64), batch)
    del plain32["state"], ref64["state"]

    out["floor32"] = _md_deltas(plain32, ref64)
    out["bf16_vs_f32"] = _md_deltas(plain, plain32)
    out["plain32_losses"], out["ref64_losses"] = plain32["losses"], ref64["losses"]
    out["stats_max"] = max(float(v.abs().max()) for k, v in ref64["full"].items()
                           if k.endswith((".mean", ".var")))
    out["layouts"] = {}
    plain_profile = profiled(plain)
    for data, model_parallel in layouts:
        mesh = make_mesh(world_size, model_parallel=model_parallel, device="cuda")
        sharded = run_steps(config, batch, mesh, census=True)
        sharded32 = run_steps(f32, batch, mesh)
        lay = {"losses": sharded["losses"], "losses32": sharded32["losses"],
               "vs_plain": _md_deltas(sharded, plain), "vs_plain_again": _md_deltas(sharded, again),
               "bf16_vs_f32": _md_deltas(sharded, plain32),
               "vs32": _md_deltas(sharded32, plain32), "vs64": _md_deltas(sharded32, ref64),
               "launches": sharded["launches"], "sync_sites": sharded["sync_sites"],
               "replay": replay(sharded32),
               "scores32": scores(sharded32, f32)}
        del sharded32
        lay.update(timed(plain, sharded))
        lay["profile"], lay["plain_profile"] = profiled(sharded), plain_profile
        lay["scores"] = scores(sharded, config)
        out["layouts"][f"{data}x{model_parallel}"] = lay
        del sharded
    out["batch"] = f"{batch[0].shape[0]}x{batch[0].shape[1] / 16000:g}s"
    out["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    return out


def multi_device_phase(layouts: tuple[tuple[int, int], ...]) -> dict:
    """multi_device_rank over data·model cards (one process a rank, one
    timeout for all). Gates, for each layout: the f32 sharded run's
    distance from the f64 run (losses, per-step gradients and BatchNorm
    stats) within MD_FLOOR_FACTOR times the plain f32 run's own (the
    loss's and the stats' floors at least `data` f32 spacings: beyond);
    its parameters within MD_REPLAY_RTOL of the replay; on a one-rank
    mesh, where no sum is split, the bf16 recipe against both plain runs
    within MD_FLOOR_FACTOR times the plain-twice floor as well (a floor of
    0 asks for bitwise equality), while a
    split sum flips bf16 roundings through the 17 blocks, so there the bf16
    deltas are printed beside the f32 gate; one log-mel, two ctc_loss and
    no quantized launch a step; no synchronizing call from the CTC loss in
    a sharded step; one lattice launch a sharded scores call (the batch
    form over the rank's rows); the sharded scores (B, 6) with the unsharded model's
    infinities and finite scores within SCORE_RTOL·max|score| (in bf16 on a
    one-rank mesh, in f32 on every layout); every rank's losses equal."""
    import numpy as np

    from tilawa_tpu_torch.parallel.dryrun import spawn

    world = layouts[0][0] * layouts[0][1]
    t = time.perf_counter()
    ranks = spawn(multi_device_rank, world, "cuda", args=(layouts,))
    wall = time.perf_counter() - t
    r = ranks[0]
    print(f"  {r['torch']}; {r['batch']}; {world} rank(s) {wall:.1f} s", flush=True)
    print(f"  plain losses bf16 {r['plain_losses']}, f32 {r['plain32_losses']}, "
          f"f64 {r['ref64_losses']}", flush=True)

    def show(what, d):
        print(f"    {what}: |Δ loss| {d['loss']}, largest per-leaf max|Δg|/max|g| {d['grad']} "
              f"{d['grad_leaf']}, params after {MD_STEPS} steps {d['params']:.4g}, BN stats "
              f"{d['stats']:.4g}", flush=True)

    def spacings(n: int, v: float) -> float:
        return n * float(np.spacing(np.float32(abs(v))))

    def beyond(d, floor, data=None, keys=("loss", "grad", "params", "stats")) -> list[str]:
        """The keys of d beyond MD_FLOOR_FACTOR times floor's. With `data`
        (the mesh's data ranks): the loss and the BatchNorm stats are sums
        split over them, which adds up to `data` roundings of the total, so
        their floors are at least `data` f32 spacings of the loss and of
        the largest stat."""
        def listed(x):
            return x if isinstance(x, list) else [x]

        floor = dict(floor)
        if data is not None:
            floor["loss"] = [max(f, spacings(data, v))
                             for f, v in zip(floor["loss"], r["ref64_losses"])]
            floor["stats"] = max(floor["stats"], spacings(data, r["stats_max"]))
        return [key for key in keys
                if not all(x <= MD_FLOOR_FACTOR * f
                           for x, f in zip(listed(d[key]), listed(floor[key])))]

    def scores_ok(sc, rows) -> bool:
        return sc["shape"] == (rows, 6) and sc["same_inf"] \
            and sc["max_err"] <= SCORE_RTOL * sc["max_abs"]

    show("bf16 plain again vs plain (floor of one rank)", r["floor"])
    show("f32 plain vs f64 (floor of split sums)", r["floor32"])
    show("bf16 plain vs f32 plain (bf16's own rounding, printed)", r["bf16_vs_f32"])
    rows = int(r["batch"].split("x")[0])
    summary = {"bucket": r["batch"], "floor": r["floor"], "floor32": r["floor32"],
               "bf16_vs_f32": r["bf16_vs_f32"],
               "child_s": wall, "layouts": {}}
    bad = []
    for name, lay in r["layouts"].items():
        one_rank = name == "1x1"
        print(f"  mesh data x model {name}: losses bf16 {lay['losses']}, f32 {lay['losses32']}",
              flush=True)
        for what, d in (("bf16 sharded vs plain", lay["vs_plain"]),
                        ("bf16 sharded vs plain again", lay["vs_plain_again"]),
                        ("bf16 sharded vs f32 plain", lay["bf16_vs_f32"]),
                        ("f32 sharded vs plain", lay["vs32"]),
                        ("f32 sharded vs f64", lay["vs64"])):
            show(what, d)
        for path in ("plain", "sharded"):
            ms, hs = sorted(lay[f"{path}_step_ms"]), sorted(lay[f"{path}_host_ms"])
            print(f"    {path} step ms (CUDA events): "
                  f"{[round(x, 2) for x in lay[f'{path}_step_ms']]}, median "
                  f"{ms[len(ms) // 2]:.2f}; host clock median {hs[len(hs) // 2]:.2f}", flush=True)
        for path, pr in (("plain", lay["plain_profile"]), ("sharded", lay["profile"])):
            print(f"    {path} step under torch.profiler: host self time "
                  f"{pr['host_self_ms']:.2f} ms, device busy {pr['device_busy_ms']:.2f} ms; "
                  f"top host ops (self ms, calls):", flush=True)
            for key, ms, count in pr["top_host_ops"]:
                print(f"      {ms:8.3f} ms  x{count:<5d} {key}", flush=True)
        for tag, sc in (("bf16", lay["scores"]), ("f32", lay["scores32"])):
            print(f"    {tag} scores {sc['shape']}: max|Δ| {sc['max_err']:.4g} of max|score| "
                  f"{sc['max_abs']:.4g} ({sc['finite']} finite), bitwise {sc['bitwise']}; "
                  f"launches {sc['launches']}", flush=True)
        print(f"    launches a sharded step {lay['launches']}; f32 parameters against the "
              f"replay of their gradients: largest per-leaf max|Δp|/max|p| {lay['replay']:.4g}",
              flush=True)
        print(f"    synchronizing calls a sharded bf16 step (each ends in its loss's read): "
              f"{[sum(d.values()) for d in lay['sync_sites']]}, at {lay['sync_sites']}",
              flush=True)
        ours = sorted({k for d in lay["sync_sites"] for k in d
                       if k.startswith("tilawa_tpu_torch/")})
        if ours:
            bad.append((name, "the port's own code synchronizes in a step", ours))
        bad += [(name, "f32", key) for key in beyond(lay["vs64"], r["floor32"],
                                                     int(name.split("x")[0]),
                                                     ("loss", "grad", "stats"))]
        if lay["replay"] > MD_REPLAY_RTOL:
            bad.append((name, "replay", lay["replay"]))
        if one_rank:
            bad += [(name, what, key) for what in ("vs_plain", "vs_plain_again")
                    for key in beyond(lay[what], r["floor"])]
        if any(n != {"int4_matmul": 0, "log_mel": 1, "int8_matmul": 0, "ctc_lattice": 0,
                     "ctc_loss": CTC_LOSS_LAUNCHES_PER_STEP} for n in lay["launches"]):
            bad.append((name, "launches", lay["launches"]))
        if any(sc["launches"]["ctc_lattice"] != 1 for sc in (lay["scores"], lay["scores32"])):
            bad.append((name, "one lattice launch a scores call",
                        [lay["scores"]["launches"], lay["scores32"]["launches"]]))
        if not scores_ok(lay["scores32"], rows) or one_rank and not scores_ok(lay["scores"], rows):
            bad.append((name, "scores", None))
        if any(o["layouts"][name]["losses"] != lay["losses"] for o in ranks[1:]):
            bad.append((name, "ranks disagree", [o["layouts"][name]["losses"] for o in ranks]))
        med = {path: sorted(lay[f"{path}_step_ms"])[len(lay[f"{path}_step_ms"]) // 2]
               for path in ("plain", "sharded")}
        summary["layouts"][name] = {
            "step_ms": med["sharded"], "plain_step_ms": med["plain"],
            "step_ms_all": lay["sharded_step_ms"], "plain_step_ms_all": lay["plain_step_ms"],
            "host_ms_all": lay["sharded_host_ms"], "plain_host_ms_all": lay["plain_host_ms"],
            **{k: lay[k] for k in ("profile", "plain_profile", "vs_plain", "vs_plain_again",
                                   "bf16_vs_f32", "vs32", "vs64", "losses", "losses32",
                                   "replay")},
            "scores_max_err": lay["scores"]["max_err"], "scores_bitwise": lay["scores"]["bitwise"],
            "scores32_max_err": lay["scores32"]["max_err"],
            "log_mel_launches": sum(n["log_mel"] for n in lay["launches"])
            + lay["scores"]["launches"]["log_mel"],
            "ctc_lattice_launches": lay["scores"]["launches"]["ctc_lattice"]
            + lay["scores32"]["launches"]["ctc_lattice"],
            "ctc_loss_launches": sum(n["ctc_loss"] for n in lay["launches"]),
            "sync_sites": lay["sync_sites"]}
    if bad:
        raise AssertionError(f"the sharded step differs from the plain one: {bad}")
    summary["log_mel_launches"] = sum(v["log_mel_launches"] for v in summary["layouts"].values())
    summary["ctc_lattice_launches"] = sum(v["ctc_lattice_launches"]
                                          for v in summary["layouts"].values())
    summary["ctc_loss_launches"] = sum(v["ctc_loss_launches"] for v in summary["layouts"].values())
    return summary


def _flat_leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def run(bundles: str | None = None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    if bundles is not None:
        missing = [str(b) for b in BUNDLE_SECTIONS[bundles]
                   if not (b / "variables.msgpack").exists()]
        if missing:
            print(f"chip_smoke: --bundles {bundles} needs {missing} in this copy",
                  file=sys.stderr, flush=True)
            return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval import validate_streaming
    from tilawa_tpu_torch.eval.experiments import get_experiment, load_champion, load_runtime
    from tilawa_tpu_torch.eval.runner import load_manifest, run_experiment
    from tilawa_tpu_torch.eval.metrics import best_emission_score, predict_to_emissions
    from tilawa_tpu_torch.io.bundle import load_variables, shipped_checkpoint
    from tilawa_tpu_torch.ops import ctc, frontend, kernels, quant
    from tilawa_tpu_torch.ops.ctc import collapse_ctc
    from tilawa_tpu_torch.parallel.dryrun import dryrun_multichip
    from tilawa_tpu_torch.pipeline import predict, rerank
    from tilawa_tpu_torch.pipeline.predict import Recognizer
    from tilawa_tpu_torch.pipeline.runtime import EncoderRuntime, StreamingEncoderCache

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
              f"{count} device(s); nvidia-smi: {smi}", flush=True)

    with phase("build"):
        report = kernels.build()
        for name, r in report.items():
            print(f"  {name}: {r['seconds']:.1f} s -> {Path(r['path']).name}", flush=True)
            for line in r["log"].splitlines():
                if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
                    print(f"    {line.strip()}", flush=True)

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEVICE)
    with phase("kernels vs plain"):
        entries = [
            check_int4(torch, np, quant, flush),
            check_log_mel(torch, np, frontend, flush),
            check_int8(torch, np, quant, flush),
            check_lattice(torch, np, ctc, flush),
        ]
        entries.append(check_ctc_loss(torch, np, ctc, flush, lattice_chain_us(entries[3])))
    del flush
    if bundles is not None:
        return bundle_section(torch, np, kernels, rerank, entries, kind, count, smi)

    manifest = {
        s["file"]: s
        for s in json.loads((CORPUS / "manifest.json").read_text())["samples"]
    }
    with phase("main path"):
        runtime = load_champion(DEVICE)
        recognizer = Recognizer(runtime, tta=True)
        recognizer.predict(CORPUS / CLIPS[0])          # warm-up (cuDNN, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        runtime.forwards = 0
        results = []
        with lattice_record(torch, rerank, keep=2) as lattice:
            for clip in CLIPS:
                t = time.perf_counter()
                pred = recognizer.predict(CORPUS / clip)
                latency = time.perf_counter() - t
                sample = manifest[clip]
                score = best_emission_score(
                    sample["expected_verses"], predict_to_emissions(pred),
                    sample.get("also_accept"),
                )
                results.append((clip, pred, latency, score["sequence_accuracy"]))
            t = time.perf_counter()
            long_text = recognizer.transcribe(CORPUS / LONG_CLIP)
            long_latency = time.perf_counter() - t
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        forwards = runtime.forwards
        peak = torch.cuda.max_memory_allocated()
        for clip, pred, latency, acc in results:
            print(f"  {clip:24s} -> {pred['surah']}:{pred['ayah']}-{pred['ayah_end']} "
                  f"score {pred['score']} tta {pred.get('tta', '-')}  "
                  f"{latency * 1e3:.1f} ms  {'ok' if acc == 1.0 else 'WRONG'}", flush=True)
        print(f"  transcribe {LONG_CLIP} ({long_latency * 1e3:.1f} ms): "
              f"{len(long_text.split())} words", flush=True)
        print(f"  forwards {forwards}; launches {launches}; per forward: int4 "
              f"{launches['int4_matmul'] / max(forwards, 1):g}, log-mel "
              f"{launches['log_mel'] / max(forwards, 1):g}; peak memory {peak} B", flush=True)
        wrong = [clip for clip, _p, _l, acc in results if acc != 1.0]
        if wrong:
            raise AssertionError(f"wrong predictions: {wrong}")
        if not long_text.strip():
            raise AssertionError(f"empty transcript for {LONG_CLIP}")
        if forwards == 0 or launches["int4_matmul"] != INT4_LAUNCHES_PER_FORWARD * forwards \
                or launches["log_mel"] != forwards:
            raise AssertionError("the main path did not run every kernel once per layer")
        check_lattice_launches("main path", launches, lattice)
        replay_err = 0.0
        for args, out in lattice["kept"]:   # two recorded chunks at their real inputs
            replay_err = max(replay_err, lattice_gate(
                torch, f"main path chunk {tuple(args[2].shape)} t_valid {args[1]}", out,
                ctc.ctc_forward_scores_plain(*args)))
        print(f"  {len(lattice['kept'])} recorded main-path chunks replayed on the plain "
              f"version: max|Δ| {replay_err:.3g}", flush=True)
        if len(lattice["kept"]) != 2:
            raise AssertionError("the main path scored fewer than two lattice chunks")
        lattice_paths = {"main path": lattice_report(torch, rerank, "main path", lattice,
                                                     len(CLIPS))}
        entries[3]["replay_max_abs_err"] = replay_err
        for e in entries[:2] + entries[3:4]:
            e["clips_launches"] = launches[e["name"]]

    with phase("plain path"):
        config, variables = load_variables(shipped_checkpoint())
        plain = EncoderRuntime(dataclasses.replace(config, use_pallas=False), variables, DEVICE)
        audio = load_audio(CORPUS / CLIPS[1])
        lp_k, ids_k, t_k = runtime.forward(audio)
        lp_p, ids_p, t_p = plain.forward(audio)
        if t_k != t_p:
            raise AssertionError(f"frame counts differ: {t_k} vs {t_p}")
        delta = float((lp_k[:t_k] - lp_p[:t_p]).abs().max())
        same = collapse_ctc(ids_k, runtime.blank_id) == collapse_ctc(ids_p, plain.blank_id)
        print(f"  {CLIPS[1]}: max|Δ log-prob| kernels vs plain ops {delta:.4g}; "
              f"collapsed ids equal: {same}", flush=True)
        if not same:
            raise AssertionError("kernel path and plain path decode differently")

    trace_clips = [(c, load_audio(CORPUS / c)) for c in (CLIPS[1], CLIPS[-1])]
    with phase("trace"):
        trace(torch, runtime, recognizer, trace_clips)

    with phase("eval"):
        with lattice_record(torch, rerank, replay=False) as lattice:
            eval_rec, eval_res, eval_launches = eval_path(
                torch, kernels, get_experiment, load_manifest, run_experiment)
        check_lattice_launches(MAIN_EXPERIMENT, eval_launches, lattice)
        for e in entries[:2] + entries[3:4]:
            e["launches"] = eval_launches[e["name"]]
        other_experiments(get_experiment, load_manifest, run_experiment)

    with phase("batched"):
        audios = []
        for sample in load_manifest("v1")[0]:
            if sample["id"] in {r["id"] for r in eval_res["per_sample"]}:
                audios.append((sample["id"], load_audio(CORPUS / sample["file"]),
                               sample.get("expected_verses",
                                          [{"surah": sample["surah"], "ayah": sample["ayah"]}])))
        no_sync_check(torch, np, eval_rec.runtime)
        with lattice_record(torch, rerank, replay=False) as lattice:
            _bres, batched_launches = batched_path(torch, np, kernels, frontend, eval_rec,
                                                   eval_res, audios)
        check_lattice_launches("batched", batched_launches, lattice)
        for e in entries[:2] + entries[3:4]:
            e["batched_launches"] = batched_launches[e["name"]]

    with phase("bench"):
        bench_child()

    with phase("streaming"):
        stream_rt = load_runtime(STREAM_BUNDLE, DEVICE, long_chunking=False)
        stream_rec = Recognizer(stream_rt)
        if stream_rt.config.quant != "int8":
            raise AssertionError(f"{STREAM_BUNDLE} is not the int8 model")
        stream_rt.forward(load_audio(CORPUS / CLIPS[1]))       # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        stream_rt.forwards = 0
        stream_rt.forward(load_audio(CORPUS / CLIPS[1]))
        torch.cuda.synchronize()
        one = dict(kernels.LAUNCHES)
        print(f"  one stream6-int8 forward: launches {one}", flush=True)
        if one != {"int4_matmul": 0, "log_mel": 1, "int8_matmul": INT8_LAUNCHES_PER_FORWARD,
                   "ctc_lattice": 0, "ctc_loss": 0}:
            raise AssertionError("a stream6-int8 forward must launch 189 int8 and 1 log-mel kernels")
        audio = load_audio(CORPUS / CLIPS[1])
        fwd = []
        for _ in range(7):
            t = time.perf_counter()
            stream_rt.forward(audio)
            fwd.append((time.perf_counter() - t) * 1e3)
        fwd_ms = sorted(fwd)[len(fwd) // 2]
        print(f"  {CLIPS[1]} stream6-int8 forward: median of 7 {fwd_ms:.2f} ms (host clock, "
              f"ends in a host read)", flush=True)
        check_profile(device_busy(torch, stream_rt, audio, fwd_ms, top=6), "stream6-int8")
        stream_launches, lattice_paths["streaming"] = streaming(
            torch, kernels, rerank, validate_streaming, stream_rec)
        entries[2]["launches"] = stream_launches["int8_matmul"]
        entries[3]["path_launches"] = {"streaming": stream_launches["ctc_lattice"]}

    with phase("streaming corpus"):
        stream_res, corpus_launches, corpus_fwd_ms = streaming_corpus(
            torch, kernels, rerank, validate_streaming, stream_rec)
        entries[2]["path_launches"] = {"streaming corpus": corpus_launches["int8_matmul"]}
        entries[3]["path_launches"]["streaming corpus"] = corpus_launches["ctc_lattice"]
        entries[1]["path_launches"] = {"streaming corpus": corpus_launches["log_mel"]}

    with phase("streaming tta"):
        tta_launches, lattice_paths["streaming tta"] = streaming_tta(
            torch, np, kernels, rerank, validate_streaming, predict, stream_rec, corpus_fwd_ms)
        for e in entries[1:4]:
            e["path_launches"]["streaming tta"] = tta_launches[e["name"]]

    with phase("cache"):
        worst = cache_check(np, load_audio, stream_rt, StreamingEncoderCache)
        batch_variance(torch, np, stream_rt, frontend, load_audio(CORPUS / "long_033_056.wav"))
        del stream_rt, stream_rec
        if not worst <= CACHE_TOL:
            raise AssertionError(f"cache vs forward_long: max|Δ log-prob| {worst} > {CACHE_TOL}")

    with phase("server"):
        serve(np, manifest, load_audio)

    with phase("champion again"):
        for name, audio in trace_clips:
            fwd, pred = zip(*(host_ms(runtime, recognizer, audio) for _ in range(7)))
            print(f"  {name} after the streaming, cache and server phases: median of 7: "
                  f"forward {sorted(fwd)[3]:.2f} ms, predict {sorted(pred)[3]:.2f} ms",
                  flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        with phase("train"):
            trained = train_phase(torch, np, kernels, Path(tmp) / "finetune")
            entries[1]["train_launches"] = trained["log_mel_launches"]
            entries[4]["launches"] = trained["ctc_loss_launches"]
            fit = fit_report_phase(torch, kernels, trained["checkpoint"])
        with phase("train vs plain"):
            versus = train_vs_plain(torch, np)
        with phase("distill"):
            distilled = distill_phase(torch, np, kernels)
            entries[0]["train_launches"] = distilled["int4_launches"]
            entries[4]["path_launches"] = {"distill": distilled["ctc_loss_launches"],
                                           "fit_report": fit["launches"]["ctc_loss"]}
        with phase("export"):
            export_phase(torch, kernels, trained["checkpoint"], Path(tmp) / "bundle", manifest)

        with phase("families"):
            paths, family_lattice = families(torch, kernels, rerank, get_experiment,
                                             load_manifest, run_experiment)
            lattice_paths.update(family_lattice)
        with phase("harnesses"):
            paths.update(harnesses(torch, np, kernels, runtime, validate_streaming, load_audio,
                                   manifest, eval_res, stream_res, Path(tmp)))
        for e, i in ((entries[0], 0), (entries[1], 1), (entries[3], 2)):
            e.setdefault("path_launches", {}).update({path: n[i] for path, n in paths.items()})

        with phase("phoneme oracle"):
            lattice = phoneme_oracle(torch, kernels, rerank, load_manifest, run_experiment)
            lattice_paths[f"{PHONEME} [oracle_rerank]"] = lattice["oracle_rerank"]
            entries[3]["path_launches"]["phoneme oracle"] = lattice["oracle_rerank"]["launches"]
        with phase("phoneme train"):
            ph_train = phoneme_train_phase(torch, np, kernels, CHAMPION, Path(tmp) / "phoneme",
                                           PHONEME_TRAIN_STEPS, keeps_head=False)
            entries[1]["path_launches"]["train.phoneme"] = ph_train["log_mel_launches"]
            entries[4]["path_launches"]["train.phoneme"] = ph_train["ctc_loss_launches"]
    with phase("multi-device"):
        multi = multi_device_phase(((1, 1),))
        entries[1]["path_launches"]["multi-device"] = multi["log_mel_launches"]
        entries[3]["path_launches"]["multi-device"] = multi["ctc_lattice_launches"]
        entries[4]["path_launches"]["multi-device"] = multi["ctc_loss_launches"]
        t = time.perf_counter()
        multi["cpu_dryrun"] = dryrun_multichip(8, device="cpu")
        multi["cpu_dryrun_s"] = time.perf_counter() - t
        print(f"  CPU (8 gloo ranks on the host, not the card; {multi['cpu_dryrun_s']:.1f} s): "
              f"{multi['cpu_dryrun']}", flush=True)
    print("chip_smoke: the phoneme-int8 and heldout-int4 bundles run under "
          "--bundles phoneme-heldout, from a copy of the repository that holds them",
          flush=True)

    entries[3]["paths"] = lattice_paths
    print(f"chip_smoke: wall {time.perf_counter() - _T0:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"train": {
        "step_ms": trained["step_ms"], "bucket": trained["bucket"],
        "audio_s_per_s": trained["audio_s_s"], "peak_bytes": trained["peak_bytes"],
        "mfu": trained["mfu"], "step_ms_by_bucket": trained["step_ms_by_bucket"],
        "sync_sites": trained["sync_sites"], "distill_step_ms": distilled["step_ms"],
        "distill_step_ms_all": distilled["step_ms_all"],
        "distill_sync_sites": distilled["sync_sites"],
        "distill_first_kl": distilled["first_kl"],
        "distill_first_kl_full_rows": distilled["first_kl_full_rows"], "vs_plain": versus,
        "phoneme_step_ms": ph_train["step_ms"], "phoneme_losses": ph_train["losses"],
        "phoneme_sync_sites": ph_train["sync_sites"], "phoneme_oracle_lattice": lattice,
        "multi_device": multi, "device": kind, "nvidia_smi": smi}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: v for k, v in e.items() if k not in keys}}
        for e in entries
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def bundle_section(torch, np, kernels, rerank, entries: list, kind: str, count: int,
                   smi: str) -> int:
    """--bundles phoneme-heldout, after the device, build and kernel phases:
    phoneme-int8 through the port's runner over v1 (one forward's launches;
    rerank off and on, decisions against the JAX package's live run),
    heldout-int4 through the runner (decisions against the JAX package's
    live run, 189 int4 + 1 log-mel a forward, one lattice launch a scorer
    chunk), then train.phoneme's continuation from phoneme-int8."""
    from tilawa_tpu_torch.data.audio import load_audio
    from tilawa_tpu_torch.eval.experiments import get_experiment
    from tilawa_tpu_torch.eval.jax_refs import HELDOUT_REF, load_ref
    from tilawa_tpu_torch.eval.runner import load_manifest, run_experiment

    with phase("phoneme bundle"):
        exp = get_experiment(PHONEME, DEVICE)
        rt = exp.runtime
        if exp.acoustics != "real" or rt.config.quant != "int8" or rt.config.num_classes != 70:
            raise AssertionError(f"{PHONEME} runs {exp.acoustics} acoustics on {rt.config}")
        audio = load_audio(CORPUS / CLIPS[1])
        rt.log_probs(audio)                                   # warm-up
        (lp, t), one, _fw = counted(torch, kernels, [rt], lambda: rt.log_probs(audio))
        print(f"  one phoneme-int8 forward of {CLIPS[1]}: log-probs {tuple(lp.shape)}, t_valid "
              f"{t}; launches {one}", flush=True)
        if one != {"int4_matmul": 0, "log_mel": 1, "int8_matmul": INT8_LAUNCHES_PER_FORWARD,
                   "ctc_lattice": 0, "ctc_loss": 0} or lp.shape[-1] != 70:
            raise AssertionError("a phoneme-int8 forward must launch 189 int8 and 1 log-mel "
                                 "kernels and give 70 classes")
        lattice = {}
        for section in ("real", "real_rerank"):
            res, launches, fw, lattice[section] = phoneme_run(
                torch, kernels, rerank, exp, [rt], section, load_manifest, run_experiment)
            if fw[0] == 0 or launches != {"int4_matmul": 0, "log_mel": fw[0],
                                          "int8_matmul": INT8_LAUNCHES_PER_FORWARD * fw[0],
                                          "ctc_lattice": lattice[section]["chunks"],
                                          "ctc_loss": 0}:
                raise AssertionError(f"{PHONEME} [{section}]: launches {launches} over {fw} "
                                     f"forwards, want 189 int8 + 1 log-mel a forward and "
                                     f"one lattice launch a scorer chunk")
            if res["total"] < MIN_EVAL_CLIPS:
                raise AssertionError(f"only {res['total']} clips scored")
            if section == "real":
                entries[2]["launches"] = launches["int8_matmul"]
                entries[1]["launches"] = launches["log_mel"]
                p50 = res["p50_latency"]
                recorded = {r["id"]: _pairs(r["predicted"]) for r in json.loads(
                    JAX_PHONEME_RUN.read_text())[0]["per_sample"]}
                moved = [r["id"] for r in res["per_sample"]
                         if _pairs(r["predicted"]) != recorded[r["id"]]]
                print(f"  against the record {JAX_PHONEME_RUN.name} (today's JAX package "
                      f"differs from it on 3 of 44 clips): verses differ on {moved}", flush=True)
        entries[2]["phoneme_head_launches"] = entries[2]["launches"] // INT8_LAUNCHES_PER_FORWARD
        entries[3]["path_launches"] = {f"{PHONEME} [real_rerank]":
                                       lattice["real_rerank"]["launches"]}

    with phase("heldout bundle"):
        rec = get_experiment("heldout", DEVICE)
        if rec.runtime.config.quant != "int4" or not rec.tta:
            raise AssertionError("heldout must be the int4 bundle with TTA")
        samples, corpus_dir = load_manifest("v1")
        with lattice_record(torch, rerank, replay=False) as heldout_lattice:
            res, launches, fw, ours = runner_decisions(torch, kernels, "heldout", rec,
                                                       rec.runtime, [rec.runtime], samples,
                                                       corpus_dir, run_experiment)
        recorded = {r["id"]: _pairs(r["predicted"])
                    for r in json.loads(JAX_HELDOUT_RUN.read_text())[0]["per_sample"]}
        old = [(i, recorded[i]) for i in ours if ours[i]["predicted"] != recorded[i]]
        tta = sum(bool(r["tta"]) for r in ours.values())
        print(f"  heldout: N={res['total']} recall {res['recall']:.4f} seq_acc "
              f"{res['sequence_accuracy']:.4f} p50 {res['p50_latency'] * 1e3:.2f} ms, TTA on "
              f"{tta} clips; launches {launches} over {fw} forwards; differs from the record "
              f"{JAX_HELDOUT_RUN.name} on {old}", flush=True)
        ref = load_ref(HELDOUT_REF)
        ties = compare_decisions("heldout", ours, ref)
        # a clip may differ from the record where it is a near tie, or where
        # today's JAX package differs from the record too
        stale = [i for i, _v in old if i not in ties and ref[i]["predicted"] == recorded[i]]
        if stale:
            raise AssertionError(f"heldout differs from {JAX_HELDOUT_RUN.name} on {stale}")
        errors = [d["id"] for d in res["dispositions"] if d["status"] == "error"]
        if errors or res["total"] < MIN_EVAL_CLIPS:
            raise AssertionError(f"heldout: errors {errors}, {res['total']} clips")
        check_lattice_launches("heldout", launches, heldout_lattice)
        if fw[0] == 0 or launches != {"int4_matmul": INT4_LAUNCHES_PER_FORWARD * fw[0],
                                      "log_mel": fw[0], "int8_matmul": 0,
                                      "ctc_lattice": heldout_lattice["chunks"],
                                      "ctc_loss": 0}:
            raise AssertionError("heldout did not run 189 int4 and 1 log-mel launches a forward "
                                 "and one lattice launch a scorer chunk")
        entries[0]["launches"] = launches["int4_matmul"]
        entries[3]["launches"] = launches["ctc_lattice"]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_phoneme_") as tmp:
        with phase("phoneme continuation"):
            cont = phoneme_train_phase(torch, np, kernels, PHONEME_BUNDLE, Path(tmp) / "cont",
                                       CONTINUE_STEPS, keeps_head=True)
            entries[1]["train_launches"] = cont["log_mel_launches"]
            entries[4]["launches"] = cont["ctc_loss_launches"]

    print(f"chip_smoke: wall {time.perf_counter() - _T0:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"bundles": {"phoneme_p50_s": p50, "phoneme_lattice": lattice,
                                  "continuation_step_ms": cont["step_ms"],
                                  "continuation_losses": cont["losses"],
                                  "device": kind, "nvidia_smi": smi}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: v for k, v in e.items() if k not in keys}}
        for e in entries
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def run_layouts(spec: str) -> int:
    """--layouts: the "multi-device" phase alone over every card present,
    one mesh a layout (DATAxMODEL, comma-separated; each must use every
    card)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    layouts = tuple(tuple(int(n) for n in s.split("x")) for s in spec.split(","))
    count = torch.cuda.device_count()
    if any(len(lay) != 2 or lay[0] * lay[1] != count for lay in layouts):
        print(f"chip_smoke: --layouts {spec} must use all {count} cards in each layout",
              file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    from tilawa_tpu_torch.ops import kernels

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {count} x {kind}; "
              f"nvidia-smi: {smi}", flush=True)
    with phase("build"):
        for name, r in kernels.build().items():
            print(f"  {name}: {r['seconds']:.1f} s -> {Path(r['path']).name}", flush=True)
    with phase("multi-device"):
        multi = multi_device_phase(layouts)
    print(json.dumps({"multi_device": multi, "device": kind, "count": count,
                      "nvidia_smi": smi}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def lattice_plans(ctc, l_pad: int, c: int, b: int, t_valid) -> list:
    """lattice_plan's own layout for (L_pad, C, B, t_valid) first, then
    each other variant it accepts there."""
    plans = [ctc.lattice_plan(l_pad, c, b, t_valid=t_valid)]
    for variant in ("warp", "group", "cluster"):
        try:
            plan = ctc.lattice_plan(l_pad, c, b, variant=variant, t_valid=t_valid)
        except ValueError:      # the variant cannot hold these states
            continue
        if plan not in plans:
            plans.append(plan)
    return plans


def loss_plans(ctc, l_pad: int, b: int) -> list:
    """loss_plan's own layout for (L_pad, B) first, then each other layout
    it accepts there: one warp, one block, and a cluster of each size (a
    block of one warp is the warp layout)."""
    plans = [ctc.loss_plan(l_pad, b)]
    forced = [("warp", None), ("group", None)] + [("cluster", c) for c in ctc.LOSS_CLUSTERS]
    for variant, cluster in forced:
        try:
            plan = ctc.loss_plan(l_pad, b, variant=variant, cluster=cluster)
        except ValueError:      # the layout cannot hold these states
            continue
        if all((p.warps, p.cluster) != (plan.warps, plan.cluster) for p in plans):
            plans.append(plan)
    return plans


def loss_layouts(torch, np, ctc, flush) -> list:
    """Every CTC_LOSS_CASES shape (check_ctc_loss's inputs) under each layout
    loss_plans gives: the loss bitwise the plain one, the gradient gated
    against the plain one (ctc_loss_gate) and bitwise the default layout's,
    the kernels' forward + backward ms, and each launch alone (forward:
    normalizer and alpha chain; backward: adjoint chain and epilogue). A
    layout that fails to launch or to match fails the run."""
    sweep = []
    for i, (label, b, t, v, l_pad, l_max) in enumerate(CTC_LOSS_CASES):
        x, enc, tokens, lens, blank = ctc_loss_case(torch, np, b, t, v, l_pad, l_max,
                                                    SEED + 40 + i)
        weight = torch.full((b,), 1.0 / b, device=DEVICE)
        ref_loss = ctc.ctc_loss_plain(x, enc, tokens, lens, blank)
        ref_grad = ctc.ctc_loss_grad_plain(x, enc, tokens, lens, blank, weight)
        first = None
        for plan in loss_plans(ctc, l_pad, b):
            def run(plan=plan):
                return ctc_loss_kernel(ctc, x, enc, tokens, lens, blank, weight, plan)
            loss, grad = run()
            torch.cuda.synchronize()
            what = f"ctc loss {label} {plan.describe()}"
            _rel, ratio = ctc_loss_gate(torch, what, loss, grad, ref_loss, ref_grad)
            if not torch.equal(bits(torch, loss), bits(torch, ref_loss)):
                raise AssertionError(f"{what}: the loss is not bitwise the plain one")
            first = first or (loss, grad)
            if not torch.equal(bits(torch, grad), bits(torch, first[1])):
                raise AssertionError(f"{what}: the gradient differs from the default layout's")
            ms = time_cuda(torch, run, flush)
            _loss, work = ctc._loss_forward_kernel(x, enc, tokens, lens, blank, plan)
            fwd_ms = time_cuda(torch, lambda: ctc._loss_forward_kernel(x, enc, tokens, lens,
                                                                      blank, plan), flush)
            bwd_ms = time_cuda(torch, lambda: ctc._loss_backward_kernel(
                x, enc, tokens, lens, blank, weight, *work), flush)
            print(f"  ctc loss {label:18s} {plan.describe()}: loss bitwise, gradient "
                  f"{ratio:.3g} of max|g|; {ms:.4f} ms (forward {fwd_ms:.4f}, backward "
                  f"{bwd_ms:.4f})", flush=True)
            sweep.append({"label": label, "plan": dataclasses.asdict(plan), "ms": ms,
                          "forward_ms": fwd_ms, "backward_ms": bwd_ms, "grad_ratio": ratio})
        del x, ref_grad, first
    return sweep


def loss_times(torch, np, ctc, flush) -> dict:
    """The loss kernels of the port imported as `ctc` (another checkout's,
    for --lattice-times) at every CTC_LOSS_CASES shape with that port's
    default layout: loss and gradient gated against that port's plain
    versions, forward + backward ms; None where that port does not take
    the shape (labels past its limit)."""
    times = {}
    for i, (label, b, t, v, l_pad, l_max) in enumerate(CTC_LOSS_CASES):
        x, enc, tokens, lens, blank = ctc_loss_case(torch, np, b, t, v, l_pad, l_max,
                                                    SEED + 40 + i)
        try:
            ctc._loss_layout(label, x, enc, tokens, lens, blank)
        except ValueError:
            times[label] = None
            continue
        weight = torch.full((b,), 1.0 / b, device=DEVICE)
        loss, grad = ctc_loss_kernel(ctc, x, enc, tokens, lens, blank, weight)
        ctc_loss_gate(torch, f"ctc loss {label}", loss, grad,
                      ctc.ctc_loss_plain(x, enc, tokens, lens, blank),
                      ctc.ctc_loss_grad_plain(x, enc, tokens, lens, blank, weight))
        times[label] = time_cuda(torch, lambda: ctc_loss_kernel(ctc, x, enc, tokens, lens,
                                                                blank, weight), flush)
        del x, grad
    return times


def lattice_inputs(torch, np, ctc, label, t, v, c, l_pad, t_valids, lengths, seed) -> tuple:
    """One sweep shape on the card: (log-probs [B, T, V], t_valid as the
    wrapper takes it, tokens, lengths, the plain version's scores [B, C]);
    B = 4 rows for the batch form, as check_lattice builds them."""
    lp, tokens, lens = lattice_case(torch, np, t, v, c, l_pad, lengths, seed)
    if len(t_valids) > 1:
        lp = torch.stack([lp, lp.flip(0), lp.roll(7, 0), lp * 1.5]).log_softmax(-1)
        tv = torch.tensor(t_valids, dtype=torch.int32, device=DEVICE)
        ref = ctc.ctc_forward_scores_batch_plain(lp, tv, tokens, lens, v - 1)
    else:
        lp, tv = lp[None], t_valids[0]
        ref = ctc.ctc_forward_scores_plain(lp[0], tv, tokens, lens, v - 1)[None]
    return lp, tv, tokens, lens, ref


def lattice_sweep_cases() -> list:
    """(label, T, V, C, L_pad, t_valids, lengths, seed): every LATTICE_CASES
    row with check_lattice's seed, then the batch form's."""
    cases = [(label, t, v, c, l_pad, (t_valid,), lengths, SEED + 10 + i)
             for i, (label, t, v, c, l_pad, t_valid, lengths) in enumerate(LATTICE_CASES)]
    cases.append(("batch B=4", 512, 1025, 64, 128, LATTICE_BATCH_T_VALID,
                  (128, 90, 33, 6, 1), SEED + 9))
    return cases


def device_line(torch) -> tuple[str, int, str]:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
          f"nvidia-smi: {smi}", flush=True)
    return kind, torch.cuda.device_count(), smi


def run_lattice_sweep() -> int:
    """--lattice: the build, the CTC kernels' kernel-vs-plain checks at every
    shape (check_lattice, check_ctc_loss), then every lattice shape under
    each layout lattice_plan accepts there (lattice_plans): scores bitwise
    the plain version's, the kernel's ms and us a frame; then every loss
    shape under each layout loss_plan accepts (loss_layouts). A layout that
    fails to build, to launch or to match fails the run."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from tilawa_tpu_torch.ops import ctc, kernels

    with phase("device"):
        kind, count, smi = device_line(torch)
    with phase("build"):
        for name, r in kernels.build(("ctc_lattice", "ctc_loss")).items():
            print(f"  {name}: {r['seconds']:.1f} s -> {Path(r['path']).name}", flush=True)
            for line in r["log"].splitlines():
                if any(w in line for w in ("registers", "spill", "smem", "stack", "Compiling")):
                    print(f"    {line.strip()}", flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEVICE)
    with phase("kernels vs plain"):
        entry = check_lattice(torch, np, ctc, flush)
        loss_entry = check_ctc_loss(torch, np, ctc, flush, lattice_chain_us(entry))
    with phase("clocks"):
        # the SM clock while one candidate's chain runs back to back (~2 s)
        lp, tokens, lens = lattice_case(torch, np, 512, 1025, 1, 128, (1,), SEED)
        smi_clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader", "-lms", "250"], stdout=subprocess.PIPE, text=True)
        t_end = time.perf_counter() + 2.0
        while time.perf_counter() < t_end:
            for _ in range(20):
                ctc.ctc_forward_scores(lp, 257, tokens, lens, 1024)
            torch.cuda.synchronize()
        smi_clocks.terminate()
        clocks = smi_clocks.communicate(timeout=30)[0].strip().splitlines()
        print(f"  SM clock, max, power while the chain floor runs: {clocks}", flush=True)
        del lp
    sweep = []
    with phase("lattice layouts"):
        for label, t, v, c, l_pad, t_valids, lengths, seed in lattice_sweep_cases():
            lp, tv, tokens, lens, ref = lattice_inputs(torch, np, ctc, label, t, v, c, l_pad,
                                                       t_valids, lengths, seed)
            frames = min(max(t_valids), t) - 1
            for plan in lattice_plans(ctc, l_pad, c, len(t_valids),
                                      t_valids[0] if len(t_valids) == 1 else None):
                def run(plan=plan):
                    return ctc._launch("lattice sweep", lp, tv, tokens, lens, v - 1, plan)
                out = run()
                torch.cuda.synchronize()
                if not torch.equal(bits(torch, out), bits(torch, ref)):
                    raise AssertionError(f"lattice {label} {plan}: not bitwise the plain "
                                         "version")
                ms = time_cuda(torch, run, flush)
                us = ms * 1e3 / frames if frames > 0 else None
                print(f"  {label:15s} {plan.describe()}: bitwise; {ms:.4f} ms"
                      f" ({'-' if us is None else f'{us:.4f}'} us a frame)", flush=True)
                sweep.append({"label": label, "plan": dataclasses.asdict(plan), "ms": ms,
                              "us_per_frame": us})
            del lp, ref
    with phase("loss layouts"):
        loss_sweep = loss_layouts(torch, np, ctc, flush)
    print(json.dumps({"lattice": entry, "ctc_loss": loss_entry, "sweep": sweep,
                      "loss_sweep": loss_sweep, "clocks": clocks, "device": kind,
                      "count": count, "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def run_lattice_times(root: str) -> int:
    """--lattice-times ROOT: the CTC kernels of the port in checkout ROOT
    (its ops/ctc.py, built from its own sources) with that port's default
    layouts: the lattice at every lattice_sweep_cases shape, scores bitwise
    that port's plain version, and the training loss at every
    CTC_LOSS_CASES shape (loss_times); kernel ms (CUDA events, L2 flushed).
    One JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np

    from tilawa_tpu_torch.ops import ctc

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEVICE)
    times = {}
    for label, t, v, c, l_pad, t_valids, lengths, seed in lattice_sweep_cases():
        lp, tv, tokens, lens, ref = lattice_inputs(torch, np, ctc, label, t, v, c, l_pad,
                                                   t_valids, lengths, seed)
        if len(t_valids) > 1:
            def run():
                return ctc.ctc_forward_scores_batch(lp, tv, tokens, lens, v - 1)
        else:
            def run():
                return ctc.ctc_forward_scores(lp[0], tv, tokens, lens, v - 1)[None]
        out = run()
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, out), bits(torch, ref)):
            raise AssertionError(f"lattice {label} in {root}: not bitwise its plain version")
        times[label] = time_cuda(torch, run, flush)
        del lp, ref
    loss = loss_times(torch, np, ctc, flush)
    print(json.dumps({"root": root, "ms": times, "loss_ms": loss,
                      "source": str(Path(ctc.__file__).resolve())}), flush=True)
    return 0


def run_lattice_compare(roots: str) -> int:
    """--lattice-compare ROOT,...: this checkout's CTC kernels beside each
    other checkout's (a `git archive` of another commit, unpacked in an
    ignored directory) at every lattice_sweep_cases shape and every
    CTC_LOSS_CASES shape, all in this one call: --lattice-times in a child
    process a checkout, in the order this, ROOT..., then reversed, so each
    is timed twice, first and last around the others. Prints each shape's
    two times a checkout and their ratio to this checkout's (null where a
    checkout does not take the shape), then the nvidia-smi line and the ok
    line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    kind, count, smi = device_line(torch)
    order = [str(ROOT)] + [str(Path(r).resolve()) for r in roots.split(",") if r]
    for r in order[1:]:
        if not (Path(r) / "tilawa_tpu_torch" / "ops" / "ctc.py").is_file():
            print(f"chip_smoke: no port in {r}", file=sys.stderr, flush=True)
            return 1
    runs: dict[str, list[dict]] = {r: [] for r in order}
    for r in order + order[::-1]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--lattice-times",
                               r], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr, flush=True)
            print(f"chip_smoke: --lattice-times {r} failed", file=sys.stderr, flush=True)
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[r].append({**line["ms"], **{f"loss {k}": ms
                                         for k, ms in line.get("loss_ms", {}).items()}})
    mine = runs[str(ROOT)]
    table = {}
    for label in mine[0]:
        base = min(m[label] for m in mine)
        row = {r: [m.get(label) for m in runs[r]] for r in order}
        table[label] = row

        def shown(times):
            if None in times:
                return "- (not taken)"
            return f"{times[0]:.4f} / {times[1]:.4f} ms ({min(times) / base:.3f}x this)"
        print(f"  {label:24s} " + "  ".join(f"{Path(r).name}: {shown(row[r])}" for r in order),
              flush=True)
    print(json.dumps({"lattice_compare": table, "roots": order, "device": kind,
                      "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="smoke run of the port on one CUDA card")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--bundles", choices=sorted(BUNDLE_SECTIONS), default=None,
                      help="run the section of these bundles instead of the default phases "
                           "(a copy of the repository that holds them)")
    mode.add_argument("--layouts", default=None, metavar="DATAxMODEL,...",
                      help="run the multi-device phase alone over every card present, one "
                           "mesh a layout, e.g. 2x2,1x4,4x1 on four cards")
    mode.add_argument("--lattice", action="store_true",
                      help="run the CTC lattice kernel alone, every shape under each layout "
                           "that fits")
    mode.add_argument("--lattice-compare", default=None, metavar="ROOT,...",
                      help="time this checkout's lattice kernel beside the port in each "
                           "other checkout ROOT at every lattice shape")
    mode.add_argument("--lattice-times", default=None, metavar="ROOT",
                      help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    try:
        if args.lattice:
            return run_lattice_sweep()
        if args.lattice_compare is not None:
            return run_lattice_compare(args.lattice_compare)
        if args.lattice_times is not None:
            return run_lattice_times(args.lattice_times)
        if args.layouts is not None:
            return run_layouts(args.layouts)
        return run(args.bundles)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED in {e}", file=sys.stderr, flush=True)
        return 1
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
