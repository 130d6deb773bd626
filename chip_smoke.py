#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sigmap_tpu_torch) on one GPU.

  python3 chip_smoke.py                  # 12 Mb genome, 2048 reads, B=2048

1. prints the versions, fails when no CUDA device is visible, then prints
   the card (nvidia-smi name and power limit);
2. builds the CUDA kernels (csrc/) and the native core from the checkout;
3. compares each turbo kernel (B1-B4) with its plain PyTorch version on the
   card, exactly, on the inputs the main path's own functions produce for
   the first batch of the workload below, and times both with CUDA events
   (median after warm-up); B3 also runs the full round 0 (its
   pair-evaluations, tile steps per block, time and bound, its dense-path
   drains, and its time at radius 0, where nothing matches and nothing is
   drained) and adversarial blocks (ties, overflowing candidate lists,
   padding seeds; dims 1, 6 and 8), and prints its ptxas registers, stack
   and spills; B4 runs on round 1's anchors with round 0's carry, on round
   0 (an empty carry, the ring filling up) and on adversarial reads (ties,
   a wrapping ring, empty blocks), whole and in windows of ADV_WINDOW_ROWS
   rows; B1 and B2 also on adversarial rows (ragged lengths, R, C and E off
   the kernels' tile sizes; B2's steps at delta and one ulp either side);
   the rescue's search kernel (rescue_search) runs on the first rescue
   chunk of the first read, as the exact engine asks the mapper's card
   search for it, over the whole tile store: its counts and candidates
   equal its plain version's, the rotation's rounding stays 100 times
   under EPS, and the card search's answer equals the k-d tree's on every
   chunk of that read;
4. drives the main path through the CLI (``-i`` then ``-m``) on a synthetic
   genome with BLOW5 (zlib) reads, scores the PAF against the simulation
   truth, checks that every kernel of the path was launched, and prints
   each CUDA graph of the mapper (``mapping/graphs.py``: the round graph,
   the head graph of each head block shape) with its replays, capture ms
   and pool MiB; a round graph must have replayed;
5. maps the reads again with the rescue oracle built (warm): on an eager
   pass the sweep's tile steps and pair-evaluations per round, split
   between blocks made only of SEED_PAD seeds and the rest, and each
   round's B3 time with the blocks longest first (the main path) and in
   cell-key order; then OVERLAP_PASSES passes with the graphs on and as
   many off in turns after an untimed pass, records equal to the eager
   pass's apart from mt:, each with its reads/s, each batch's round loop
   and the host ms a round takes to send its work and to get its host
   signal back; each graph's captures, replays, capture ms and pool MiB;
   and one pass each way under torch.profiler: the device's busy time
   (union of its kernel, memcpy and memset intervals) and idle share, B3
   and B4 once a round in the trace, and the gaps between device intervals
   (the ten longest, the stretches before the first and after the last
   interval among them) with the host ops that ran in each;
6. the debug modes and B5: B5 == plain at bench.py's DTW shape, on
   ``sdtw_adversarial`` (band and pass edges, ragged, empty and tied pairs)
   and on the debug path's own full-width inputs (a 48,502-base reference,
   64 reads of 3000 bases), with B5's plan at each of the three shapes, its
   time under plan's other choices, and its ptxas registers, stack and
   spills; then ``--debug-mode dtw-align`` and ``cwt-align`` through
   the CLI, three runs each (one line per pair, B5 launched; the host's
   pair preparation timed apart), then the ``events-to-text``
   and ``fast5-to-text`` dumps of the same reads;
7. the exact engine through the CLI on phase 4's index: ``--engine exact``
   on the first EXACT_READS reads and ``--batch-mode`` on the first
   BATCH_MODE_READS, each scored like phase 4; B1/B2 == plain first on
   each path's own rows (the streaming wavefront's first chunks, batch
   mode's whole reads);
8. the turbo path at TurboParams(S=1024, K=16), whose reads B4 takes in
   windows: B4 == plain on round 0's and round 1's anchors of the first
   batch (valid rows, windows, scratch bytes, bound), timed in the
   default windows (three blocks an SM) and in the largest; then
   ``streaming_map``
   of the first WIDE_READS reads, scored like phase 4, every turbo kernel
   launched, the round graph replayed (its replays, capture ms, pool MiB);
9. tests/test_torch_gpu.py under pytest (``-m gpu --noconftest``): every
   case must pass, none skip; its summary line is printed;
10. the round-5 workload (BENCH_r05.json): THREE_BATCH_READS reads of phase
    4's genome at read batch THREE_BATCH_B, three batches, HOST_THREADS host
    threads (bench.py:240-241), on phase 4's index: ``-m`` through the CLI,
    scored like phase 4, B1-B4 launched; then on one mapper with phase 5's
    rescue oracle, OVERLAP_PASSES warm passes with the cross-batch overlap
    on and as many with it off, alternated after an untimed pass, all with
    the graphs, their records equal apart from mt: to an eager pass's
    (graphs off), with each pass's head (batch 0's
    preparation), its waits between batches, its rounds and its rescue
    tail (``TurboMapper.last_pass``); the same at -t 1 on the first
    SWEEP_READS reads at each of SWEEP_BATCHES read batches; on the
    round-5 workload and at the CLI's default read batch, the mapper's
    default way must not be slower in every pass than the other way in
    every pass; batch 0's head alone (host staging, all of
    prepare_batch); one overlapped pass under torch.profiler: device
    busy and idle share, the longest device gaps, and per batch the time
    the side stream's work (upload, quantization, batch_features: B1, B2
    and their glue) and the main stream's (the rounds: B3, B4 and theirs)
    ran at once, which must be above zero for batches 1 and 2 (the
    streams do not serialise); B1/B2 against B3/B4 alone is printed
    beside it;
11. the sharded mapper (``parallel.turbo_shard.TurboShardMapper``, a round
    two graphs around its eager merge; each graph's replays printed) on
    phase 4's index at the default TurboParams: (a) in this process, a
    one-rank NCCL group, mesh (1, 1), on the first SHARD_READS reads at
    that read batch, beside the single-device TurboMapper (both with phase
    5's rescue oracle): an untimed pass each, then SHARD_PASSES warm passes
    each in turns, reads/s, the merge's ms a round (CUDA events around
    gather, sort and sum) and the rounds a batch; (b) two gloo ranks on
    the one card as subprocesses (tests/_torch_shard_worker.py), meshes
    (1, 2) and (2, 1), on the first SHARD_GLOO_READS reads at that read
    batch, with each run's wall and reads/s (gloo stages through the host:
    not a multi-GPU figure), SHARD_GLOO_PASSES passes a rank, the first
    cold.  Every record equals the single-device mapper's apart from mt:,
    but for reads whose capacity overflowed (row 7 of rb_i; at K=8 on this
    index nearly every read), which are counted; both rescue as many
    reads.  Every record also equals, apart from mt: and with no read
    exempt, a one-process emulation of the run's mesh
    (``threaded_shard_map``: one mapper a tile shard on a thread each,
    the slots merged by ``merge_shard_matches`` at a barrier), and so do
    the overflow and rescued reads; any rank's failure fails the phase.
12. long reads (``long_read_phase``): LONG_READS reads of log-normal
    lengths (median LONG_MEDIAN bases, sigma LONG_SIGMA, clipped to
    LONG_CLIP; about 9% pass the 30-chunk cap), LONG_OFF of them from a
    random genome that is not indexed, on phase 4's index at read batch
    LONG_BATCH and HOST_THREADS threads, with phase 5's rescue oracle: an
    eager pass, then LONG_GRAPH_PASSES passes with the graphs, records
    equal apart from mt:, on-target reads scored like phase 4 (99%),
    off-target ones mapped counted (false positives, not gated), rounds a
    batch, reads at the cap, overflow and rescued reads, the rescue tail,
    B1/B2 once a head block; the head's blocks and ms at NC=30 and its ms
    a row at each block size of HEAD_BLOCK_TRIES; each graph's pool; then
    one batch of the same reads cut to each of the ten chunk buckets,
    prepared with the graphs and equal exactly to the whole batch's head
    run eagerly in one block, with each bucket's rows, blocks and head ms,
    and the head graphs' pools after all ten buckets (at most
    HEAD_POOL_LIMIT_MIB), and the memory reserved.

A line before the last is the per-kernel JSON record (each kernel's
launches, max_abs_err, ms, plain_ms, its bound from the operations and bytes
of this run's inputs, library_ms), the last line ``{"ok": true, "device":
{...}}``.  Any failure raises (non-zero exit, no result line).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

READ_BASES = 3000     # read length of the round-5 workload
SEED = 1              # genome seed; reads use SEED + 1
SWEEP_BLOCKS = 256    # seed blocks of a full round checked against plain B3
DEBUG_GENOME = 48_502  # bases of the debug modes' reference (lambda phage)
DEBUG_READS = 64       # reads of the debug modes, whole against the reference
DTW_SHAPE = (1024, 2048, 512)   # bench.py:bench_dtw's B, T, Q
# phase 7's read subsets of the phase-4 reads, cut for the time limit: the
# exact engine streams chunks on the host's chaining; batch mode seeds
# whole reads at step 1 (~8x the seeds of a streaming chunk pass)
EXACT_READS = 512
BATCH_MODE_READS = 64
EXACT_READ_BATCH = 512   # --read-batch of phase 7: one wavefront of reads
# phase 8: TurboParams whose S*K rows a read B4 takes only in windows (the
# JAX package's K=16 operating point at S=1024), on a prefix of the reads
WIDE = dict(S=1024, K=16)
WIDE_READS = 512
# phase 10: the round-5 workload (BENCH_r05.json): 6144 reads, three
# batches of 2048, 4 host threads as bench.py:240-241 runs it
THREE_BATCH_READS = 6144
THREE_BATCH_B = 2048
HOST_THREADS = 4
OVERLAP_PASSES = 3     # warm passes with the overlap on, and as many off
# and at -t 1 (the CLI's default) on the first SWEEP_READS reads at each
# of SWEEP_BATCHES read batches, the first the CLI's default
SWEEP_BATCHES = (128, 512, 1024)
SWEEP_READS = 2048
# phase 11: the sharded mapper, (a) at world size 1 on phase 4's 2048
# reads, (b) two gloo ranks on the one card, its reads cut to fit the
# phase into ~240 s (the index and the params are not cut)
SHARD_READS = 2048
SHARD_PASSES = 3
SHARD_GLOO_READS = 1024
SHARD_GLOO_MESHES = ((1, 2), (2, 1))
SHARD_GLOO_PASSES = 3    # a rank's passes, the first cold
SHARD_WORKER = os.path.join(ROOT, "tests", "_torch_shard_worker.py")
SHARD_WALL_S = 240       # a worker's wall limit
SHARD_PG_TIMEOUT_S = 180  # its process group's timeout
# phase 12: long mixed-length reads with off-target reads (Read Until
# traffic) on phase 4's genome and index, one batch at the CLI's read batch
LONG_READS = 2048
LONG_BATCH = 2048
LONG_MEDIAN = 6000       # bases; log-normal read lengths
LONG_SIGMA = 0.6
LONG_CLIP = (1000, 40_000)
LONG_OFF = 0.10          # share of reads from a genome that is not indexed
LONG_OFF_GENOME = 2_000_000
LONG_GRAPH_PASSES = 2
HEAD_BLOCK_TRIES = (4096, 8192, 12288, 16384)   # head block sizes timed
HEAD_POOL_LIMIT_MIB = 4700.0   # the head graphs' pools after all buckets

KERNELS = {
    "peaks": ("sigmap_tpu_torch/csrc/events.cu",
              "sigmap_tpu/signal/events_pallas.py:28"),
    "compress_keep": ("sigmap_tpu_torch/csrc/events.cu",
                      "sigmap_tpu/signal/events_pallas.py:143"),
    "sweep": ("sigmap_tpu_torch/csrc/sweep.cu",
              "sigmap_tpu/ops/sweep_kernel.py:44"),
    "chain_fused": ("sigmap_tpu_torch/csrc/chain_fused.cu",
                    "sigmap_tpu/ops/chain_fused.py:48"),
    "sdtw": ("sigmap_tpu_torch/csrc/sdtw.cu",
             "sigmap_tpu/ops/sdtw_kernel.py:47"),
    # no TPU kernel: the rescue's host k-d tree search
    "rescue_search": ("sigmap_tpu_torch/csrc/rescue_search.cu",
                      "sigmap_tpu_torch/csrc/core.cc:164"),
}

# chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The card's peaks for the kernels' bounds (NVIDIA's H100 SXM data sheet, at
# the full 700 W): 67 TFLOP/s of f32 outside the tensor cores counts an FMA
# as two, so 132 SMs x 128 lanes x 1.98 GHz = 33.45e12 f32 or i32 lane
# operations a second; 3.35e12 bytes a second of device memory.
OPS_PER_S = 132 * 128 * 1.98e9
BYTES_PER_S = 3.35e12
# operations each kernel's work item needs, counted from its source; B3
# does 3*dim - 1 f32 arithmetic ops a (seed, window) pair (a sub and a mul
# per dim, an add per dim after the first), plus its compares
SWEEP_COMPARES_PER_PAIR = 1  # B3: the one radius compare
PEAKS_OPS_PER_STEP = 40      # B1: two detector steps of ~20 ops per sample
KEEP_OPS_PER_EVENT = 4       # B2: sub, abs, compare, select per event
# B4: a ring-slot test that the slot's g or its target gap refuses needs
# the g compare, the target difference and its range compare; one that
# passes both needs the whole chain (the other gates, the division as one
# op, the score and the running maximum)
CHAIN_OPS_PER_REFUSAL = 3
CHAIN_OPS_PER_SLOT = 25
SDTW_OPS_PER_CELL = 5        # B5: sub, abs, two mins, add per cell
# B5 as this card issues it: FADD, two FMNMX and an FADD that takes the
# abs as an |operand| modifier; its bound is reported beside the 5-op one
SDTW_INSTR_PER_CELL = 4
SEED_PAD = 2.0e9             # mapping/sweep_search.py:SEED_PAD


def bound(ops, nbytes):
    """The least time the card could take for `ops` operations moving
    `nbytes` bytes: the larger of the two times, and which one it is."""
    t_ops = ops / OPS_PER_S * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_ops=int(ops),
                bound_bytes=int(nbytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def peaks_work(R, C):
    """B1 on R rows of C samples: t1, t2 and lengths in, (short, long)
    emissions out."""
    return R * C * PEAKS_OPS_PER_STEP, R * C * 16 + R * 4


def keep_work(R, E):
    """B2 on R rows of E events: means and counts in, the mask out."""
    return R * E * KEEP_OPS_PER_EVENT, R * E * 8 + R * 4


def chain_counts(a_t, a_g, CARRY, ring, kb, max_tgap):
    """What B4's DP has to do on anchors `a_t`, `a_g` [A, B] (rows
    0..CARRY-1 carried), whatever implements it: the valid new anchors, the
    most of them in one read, and the ring-slot tests against the *filled*
    part of the ring: a valid new anchor tests min(valid rows pushed before
    its kb-row block, ring) slots (an unfilled slot can never pass).
    `window_pairs` are the tests that the first two gates let through: the
    slot holds the anchor's g and a target 1..max_tgap positions before the
    anchor's; every other test is refused by those gates alone.
    `slot_tests_all_slots` is the earlier count, every valid new anchor
    against all `ring` slots."""
    import torch

    A, B = a_g.shape
    valid = a_g >= 0
    v = valid.long()
    vb = v[CARRY:].reshape(-1, kb, B).sum(dim=1)          # [blocks, B]
    before = v[:CARRY].sum(dim=0)[None, :] + vb.cumsum(dim=0) - vb
    per_read = vb.sum(dim=0)
    n_valid = int(per_read.sum())
    # The ring at a block's start holds the last `ring` valid rows before
    # the block.  With each read's valid rows moved to the front in row
    # order, the slots that row i tests are the ranks [before - ring,
    # before) of its read.
    reads = torch.nonzero(per_read > 0)[:, 0]
    n = int(v.sum(dim=0).max()) if B else 0
    order = torch.argsort((~valid[:, reads]).to(torch.int8), dim=0,
                          stable=True)[:n]                # [n, reads]
    t = torch.gather(a_t[:, reads], 0, order).t().contiguous()
    g = torch.gather(a_g[:, reads], 0, order).t().contiguous()
    new = (order >= CARRY) & (g.t() >= 0)
    blk = (order - CARRY).clamp(min=0) // kb
    hi = torch.where(new, torch.gather(before[:, reads], 0, blk), 0).t()
    rank = torch.arange(n, device=a_g.device)[None, None, :]
    pairs = 0
    step = max(1, (1 << 26) // max(1, n * n))             # reads a pass
    for c in range(0, reads.numel(), step):
        h = hi[c:c + step, :, None]                       # [reads, i, 1]
        d = t[c:c + step, :, None] - t[c:c + step, None, :]
        ok = ((rank < h) & (rank >= h - ring) & (d > 0) & (d <= max_tgap)
              & (g[c:c + step, :, None] == g[c:c + step, None, :]))
        pairs += int(ok.sum())
    return dict(valid_new_anchors=n_valid,
                longest_read_valid_anchors=int(per_read.max()) if B else 0,
                slot_tests=int((vb * before.clamp(max=ring)).sum()),
                window_pairs=pairs,
                slot_tests_all_slots=n_valid * ring)


def chain_work(counts, A, B, CARRY, ring):
    """B4's (operations, bytes) from chain_counts' `counts`: every
    filled-slot test costs the refusal, a test that the g and target-gap
    gates let through the rest of a whole test as well; the anchors and
    the carry in, the carry-out rings and the summaries out."""
    return (counts["slot_tests"] * CHAIN_OPS_PER_REFUSAL
            + counts["window_pairs"]
            * (CHAIN_OPS_PER_SLOT - CHAIN_OPS_PER_REFUSAL),
            A * B * 16 + CARRY * B * 4 * 5 + ring * B * 4 * 8 + B * 16 * 4)


ADV_WINDOW_ROWS = 16   # B4's window on chain_adversarial: 4 windows a read


def chain_adversarial(seed=0):
    """B4 inputs (numpy: the nine arrays of chain_fused, and radius, dim,
    ring) for B = 13 reads, CARRY = RING = 16 and 64 new rows, one read a
    rule; the new rows tile by kb = 1, 4, 8 and 16, and reads 8-12 set
    rules across the windows of ADV_WINDOW_ROWS new rows:
    0 two ring slots give one new anchor equal candidate scores (the lowest
      slot must win: the slots carry different chain starts);
    1 every row valid on one diagonal: more than RING valid rows, so the
      ring wraps inside the call;
    2 aligned runs of 8 valid rows with one g and one q, as a seed's K
      matches are, between runs of invalid rows;
    3 only invalid blocks but the last;
    4 an empty carry;
    5 no valid row at all;
    6 three identical chains on three references: chains 1, 2 and 3 tie;
    7 random anchors and a half-filled carry;
    8 a full carry, then valid rows from new row 8 to 40: the ring wraps
      across the first two window boundaries;
    9 chain 1 in window 0, chain 2 in window 1, chain 3 in windows 2-3
      ending on the read's last valid row;
    10 two chains of one score in windows 0 and 2: the first is chain 1;
    11 one chain through windows 0 and 2 with window 1 (and 3) all invalid;
    12 carried rows that overlap chain 1 (on both strands of its reference),
      with a higher score than chain 2.
    Distances are 0 in reads 0-6 and 8-12, so every score there is a whole
    number and ties are exact in any float type."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, RING, N = 13, 16, 64
    A = RING + N
    a_t = np.zeros((A, B), np.int32)
    a_q = np.zeros((A, B), np.int32)
    a_d = np.zeros((A, B), np.float32)
    a_g = np.full((A, B), -1, np.int32)
    c_score = np.zeros((RING, B), np.float32)
    c_stt = np.zeros((RING, B), np.int32)
    c_stq = np.zeros((RING, B), np.int32)
    c_n = np.zeros((RING, B), np.int32)
    c_sumd = np.zeros((RING, B), np.float32)
    new = np.arange(RING, A)

    def carried(b, rows, t, q, g, score):
        a_t[rows, b], a_q[rows, b], a_g[rows, b] = t, q, g
        c_score[rows, b], c_n[rows, b] = score, 3
        c_stt[rows, b] = t - 10 - np.arange(len(rows))   # distinct starts
        c_stq[rows, b] = q - 10

    # 0: carried slots 0 and 1 at one (t, q) with one score
    carried(0, np.array([0, 1]), 100, 10, 0, 7.0)
    a_t[new[:3], 0], a_q[new[:3], 0], a_g[new[:3], 0] = 110, 20, 0
    # 1: a full carry and every new row valid, one diagonal
    carried(1, np.arange(RING), 1000 + 3 * np.arange(RING),
            3 * np.arange(RING), 2, 6.0 + np.arange(RING))
    a_q[new, 1] = 3 * RING + 3 * np.arange(N)
    a_t[new, 1] = 1000 + a_q[new, 1]
    a_g[new, 1] = 2
    # 2: every other run of 8 rows valid, one g and one q a run
    carried(2, np.arange(4), 500 + 2 * np.arange(4), 2 * np.arange(4), 1, 6.0)
    for r in range(0, N, 16):
        rows = new[r:r + 8]
        a_q[rows, 2] = 20 + r
        a_t[rows, 2] = 520 + r + np.arange(8) * 2
        a_g[rows, 2] = 1
    # 3: invalid blocks, then one valid block
    carried(3, np.arange(3), 300 + 5 * np.arange(3), 5 * np.arange(3), 0, 6.0)
    a_q[new[-8:], 3] = 40
    a_t[new[-8:], 3] = 340 + np.arange(8)
    a_g[new[-8:], 3] = 0
    # 4: an empty carry, new rows on a diagonal with gaps
    rows = new[::3]
    a_q[rows, 4] = 4 * np.arange(len(rows))
    a_t[rows, 4] = 9000 + a_q[rows, 4]
    a_g[rows, 4] = 3
    # 6: the same chain on references 0, 1 and 2 (g = 2 * reference)
    for j, g in enumerate((0, 2, 4)):
        rows = new[j::4][:12]
        a_q[rows, 6] = 5 * np.arange(12)
        a_t[rows, 6] = 2000 + a_q[rows, 6]
        a_g[rows, 6] = g
    # 7: random, clustered on four diagonals
    keep = rng.random(A) < 0.7
    rows = np.nonzero(keep)[0]
    g7 = rng.integers(0, 4, len(rows))
    q7 = np.sort(rng.integers(0, 120, len(rows)))
    a_q[rows, 7] = q7
    a_t[rows, 7] = np.array([700, 2500, 4100, 700])[g7] + 2 * q7 \
        + rng.integers(-3, 4, len(rows))
    a_g[rows, 7] = g7
    a_d[rows, 7] = rng.random(len(rows)) * 0.08
    c_score[:, 7] = rng.random(RING) * 20
    c_stt[:, 7] = rng.integers(0, 4000, RING)
    c_stq[:, 7] = rng.integers(0, 50, RING)
    c_n[:, 7] = rng.integers(1, 20, RING)
    c_sumd[:, 7] = rng.random(RING)

    # reads 9-12: one chain anchor an 8-row block (so chains link alike at
    # kb 1, 4 and 8), seeded by carried rows, steps of 6 in t and q (a link
    # adds min(6, dim) = 6 from any earlier row, so the row just before,
    # which scores highest, is always the predecessor)
    def diagonal(b, rows, g, t0, q0):
        a_q[rows, b] = q0 + 6 * np.arange(1, len(rows) + 1)
        a_t[rows, b] = t0 + a_q[rows, b] - q0
        a_g[rows, b] = g

    # 8: a full carry, then new rows 8..40 on its diagonal
    carried(8, np.arange(RING), 1000 + 3 * np.arange(RING),
            3 * np.arange(RING), 2, 6.0 + np.arange(RING))
    a_q[new[8:41], 8] = 3 * RING + 3 * np.arange(33)
    a_t[new[8:41], 8] = 1000 + a_q[new[8:41], 8]
    a_g[new[8:41], 8] = 2
    # 9: carried seeds of 30, 20, 10 on g 0, 2, 4 extended by 2, 2 and 3
    # anchors in windows 0, 1 and 2-3: chains of 42, 32 and 28
    carried(9, np.arange(3), np.array([1000, 3000, 5000]), 0,
            np.array([0, 2, 4]), np.array([30.0, 20.0, 10.0]))
    diagonal(9, new[0:16:8], 0, 1000, 0)
    diagonal(9, new[16:32:8], 2, 3000, 0)
    diagonal(9, new[40:64:8], 4, 5000, 0)
    # 10: chains of 32 on g 0 (window 0) and g 6 (window 2)
    carried(10, np.arange(2), 1000, 0, np.array([0, 6]), 20.0)
    diagonal(10, new[0:16:8], 0, 1000, 0)
    diagonal(10, new[32:48:8], 6, 1000, 0)
    # 11: one chain of 44 through windows 0 and 2
    carried(11, np.arange(1), 4000, 0, 8, 20.0)
    diagonal(11, np.concatenate([new[0:16:8], new[32:48:8]]), 8, 4000, 0)
    # 12: a carried chain on g 2 (start 500) that the new rows extend to
    # chain 1 (46), a carried row of 30 on g 3 inside its target interval,
    # and a fresh chain of 12 on g 4 in window 3
    carried(12, np.arange(3), 500 + 6 * np.arange(3), 6 * np.arange(3), 2,
            10.0 + 6 * np.arange(3))
    c_stt[:3, 12] = 500
    carried(12, np.array([3]), 530, 5, 3, 30.0)
    c_stt[3, 12] = 510
    diagonal(12, new[0:32:8], 2, 512, 12)
    diagonal(12, new[48:64:8], 4, 7000, 100)
    return ((a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd),
            dict(radius=0.08, dim=6, ring=RING))


def peaks_adversarial(seed=0):
    """B1 inputs (numpy: t1, t2 [R, C] f32, lengths [R] i32) with R = 70
    rows (two full warps of rows and 6) and C = 201 steps (three tiles of 64
    and 9; no multiple of 4, so the wrapper pads the rows for the kernel's
    16-byte copies, while the first 200 columns alone go in as they are):
    rows of length 0,
    shorter than twice the long window, of full length, and random lengths;
    t-statistics with peaks of random height over a noisy floor.  Row 3
    holds a short-detector peak at steps 61-63 that masks the long detector
    (until step 63 + w1) across the tile boundary at step 64, where the long
    detector's own peak stands."""
    import numpy as np

    rng = np.random.default_rng(seed)
    R, C = 70, 201
    t1 = np.abs(rng.normal(0, 1.2, (R, C))).astype(np.float32)
    t2 = np.abs(rng.normal(0, 1.0, (R, C))).astype(np.float32)
    for t, every in ((t1, 9), (t2, 17)):
        for r in range(R):
            at = np.arange(int(rng.integers(2, every)), C, every)
            t[r, at] += rng.random(len(at)).astype(np.float32) * 9
    lengths = rng.integers(0, C + 1, R).astype(np.int32)
    lengths[:8] = (0, 5, 11, C, C, 1, 64, 65)
    lengths[32], lengths[69] = C, C
    t1[3, 50:80] = 0.25
    t2[3, 50:80] = 0.25
    t1[3, 60:64] = (2.0, 5.5, 8.0, 3.0)
    t2[3, 61:68] = (1.0, 2.0, 4.0, 6.0, 4.5, 2.0, 0.5)
    return t1, t2, lengths


def compress_adversarial(seed=0):
    """B2 inputs (numpy: norm [R, E] f32, n [R] i32, and delta) with R = 70
    rows (two full warps of rows and 6) and E = 203 events (three tiles of
    64 and 11; no multiple of 4, so the wrapper pads the rows):
    0-2 n = 0, 1 and E;
    3 one value throughout, then runs of equal values;
    4 steps of exactly delta from the last kept value, up and down, and one
      ulp either side (a step is kept only above delta);
    5, 6 negative zero, as the first (kept) value and as a later one;
    7 a kept value that must last across the tile boundary at event 64,
      where a step from it, not from the values since, decides;
    8 every event kept;
    9- random counts (tile boundaries among them) over runs of equal values
      and values on a 0.05 grid, whose steps fall on either side of delta."""
    import numpy as np

    rng = np.random.default_rng(seed)
    R, E = 70, 203
    d = np.float32(0.1)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    norm = rng.normal(0, 1, (R, E)).astype(np.float32)
    n = rng.integers(0, E + 1, R).astype(np.int32)
    n[:9] = (0, 1, E, E, E, E, E, E, E)
    n[9:14] = (63, 64, 65, 128, 129)
    norm[3] = 0.25
    norm[3, 100:] = np.repeat(rng.normal(0, 1, 13), 8)[:E - 100]
    # a last value L (a multiple of delta's ulp, 2^-27, near 0.02) from
    # which steps of delta and of one ulp either side of it, up and down,
    # are exact in f32
    steps = (np.nextafter(d, down), d, np.nextafter(d, up))
    L = np.float32(2684355 * 2.0 ** -27)
    assert all(np.float32(L + x) - L == x and L - np.float32(L - x) == x
               for x in steps)
    ups = [np.float32(L + x) for x in steps]
    downs = [np.float32(L - x) for x in steps]
    # kept: L, then the step of one ulp above delta down, then up from L
    norm[4, :9] = (L, ups[0], ups[1], downs[0], downs[1], downs[2], L,
                   ups[2], ups[2])
    norm[5, :5] = (-0.0, 0.0, d, -d, np.nextafter(d, up))
    norm[6, :5] = (0.0, -0.0, -d, np.nextafter(-d, down), 0.0)
    # 0.5 kept, 0.45s not; 0.0 kept at event 63, the last of tile 0; then
    # steps below delta from 0.0 (but not from 0.45 or from each other)
    # until 0.11
    norm[7, :74] = 0.45
    norm[7, 0], norm[7, 63], norm[7, 64] = 0.5, 0.0, np.nextafter(d, down)
    norm[7, 65:72], norm[7, 72:74] = 0.05, (0.09, 0.11)
    norm[8] = np.arange(E, dtype=np.float32) * np.float32(0.25)
    grid = (rng.integers(-20, 21, (R - 9, E)) * np.float32(0.05)).astype(
        np.float32)
    runs = np.repeat(grid[:, ::4], 4, axis=1)[:, :E]
    norm[9:] = np.where(rng.random((R - 9, 1)) < 0.5, runs, grid)
    return norm, n, float(d)


def sdtw_work(t_len, q_len, T, Q):
    """B5: every cell of every pair; targets, queries and results."""
    B = t_len.shape[0]
    cells = int((t_len.long() * q_len.long()).sum())
    return cells * SDTW_OPS_PER_CELL, (B * (T + Q)) * 4 + B * 16


def sdtw_adversarial(seed=0):
    """B5 inputs: {name: (launch (a make_plan) or None for plan's own, (targets [B, T], t_len [B], queries [B, Q], q_len [B])
    numpy)}:
    edges_<R>_<warps>_<cluster>: q_len 1 and each band and pass edge -1, 0,
      +1 under that launch (every band's first and last row holds q_len-1;
      passes through the scratch row);
    ragged: plan's launch, pairs needing 1 to all of its bands, random
      t_len;
    long_query: queries longer than their targets (t_len 1-40);
    empty: t_len 0 and q_len 0 beside ordinary pairs;
    regimes: one launch, pairs of one band, of several bands in one CTA, of
      both CTAs, and of three passes;
    ties: constant and periodic signals whose last row ties on many target
      positions (the end must be the first)."""
    import numpy as np

    from sigmap_tpu_torch.ops.sdtw_kernel import make_plan

    rng = np.random.default_rng(seed)

    def pairs(tl, ql, T=None, Q=None):
        tl, ql = np.asarray(tl, np.int32), np.asarray(ql, np.int32)
        T = T or max(1, int(tl.max()))
        Q = Q or max(1, int(ql.max()))
        ts = rng.normal(0, 1, (len(tl), T)).astype(np.float32)
        qs = rng.normal(0, 1, (len(ql), Q)).astype(np.float32)
        return ts, tl, qs, ql

    out = {}
    for R, nw, C in ((4, 2, 2), (8, 3, 1), (2, 2, 4), (8, 1, 8)):
        band = 32 * R
        prow = C * nw * band
        edges = sorted({e for k in range(1, 2 * C * nw + 1)
                        for e in (k * band - 1, k * band, k * band + 1)})
        ql = [1] + edges
        tl = rng.integers(60, 160, len(ql))
        Q = 2 * prow + 1
        out[f"edges_{R}_{nw}_{C}"] = (
            make_plan(len(ql), 160, Q, R, C, nw),
            pairs(tl, ql, 160, Q))
    ql = rng.integers(1, 3000, 12)
    out["ragged"] = (None, pairs(rng.integers(1, 400, 12), ql))
    out["long_query"] = (make_plan(6, 40, 700, 4, 2, 2),
                         pairs(rng.integers(1, 41, 6),
                               rng.integers(300, 701, 6), 40, 700))
    out["empty"] = (None, pairs([0, 50, 0, 80, 30], [20, 0, 0, 64, 1],
                                80, 64))
    out["regimes"] = (make_plan(4, 300, 1100, 4, 2, 2),
                      pairs([300, 250, 300, 280], [50, 200, 400, 1100],
                            300, 1100))
    T, Q = 240, 96
    ts = np.zeros((4, T), np.float32)
    qs = np.zeros((4, Q), np.float32)
    ts[0], qs[0] = 1.0, 1.0                       # every cell costs 0
    pat = np.array([0.0, 1.0, 2.0], np.float32)
    ts[1] = np.tile(pat, T // 3)                  # the query fits every period
    qs[1] = np.tile(pat, Q // 3)
    ts[2] = np.repeat(np.array([0.5, 2.0], np.float32), T // 2)
    qs[2] = 0.5                                    # ties over half the target
    ts[3] = np.tile(np.float32(0.25) * np.arange(8, dtype=np.float32), 30)
    qs[3, :40] = np.float32(0.25) * np.arange(8, dtype=np.float32).repeat(5)
    tl = np.array([T, T, T, T], np.int32)
    ql = np.array([Q, Q, 60, 40], np.int32)
    out["ties"] = (None, (ts, tl, qs, ql))
    return out


def sweep_work(bm, TILE, block, dim, K):
    """(pair-evaluations, bound dict) of one B3 launch on blockmeta `bm`:
    every block evaluates its seeds against each of its tiles; the bytes are
    each touched tile's dim rows and meta read once, the seeds, the table and
    the outputs."""
    import torch

    NO = (bm.shape[0] - 1) // 2
    G = bm.shape[1]
    bml = bm.long()
    steps = int(bml[2 * NO].sum())
    pairs = steps * TILE * block
    start = bml[:NO].reshape(-1)
    cnt = (bml[NO + 1:] - bml[NO:2 * NO]).reshape(-1)
    T = int((start + cnt).max()) + 1 if G else 1
    mark = torch.zeros(T + 1, dtype=torch.long, device=bm.device)
    live = cnt > 0
    mark.index_add_(0, start[live], torch.ones_like(start[live]))
    mark.index_add_(0, (start + cnt)[live], -torch.ones_like(start[live]))
    touched = int((torch.cumsum(mark, 0) > 0).sum())
    Q = G * block
    nbytes = (touched * (dim + 1) * TILE * 4 + Q * 8 * 4 + bm.numel() * 4
              + Q * K * 8 + Q * 2 * 4)
    ops_per_pair = (3 * dim - 1) + SWEEP_COMPARES_PER_PAIR
    return pairs, bound(pairs * ops_per_pair, nbytes)


def rescue_work(bm, Q, TILE, dim, candidates):
    """rescue_search's (pair-evaluations, (operations, bytes)) on
    blockmeta `bm` [2*NO+1, Q] (one seed a block): each seed against every
    window of its tile steps, at B3's operations a pair; the bytes are each
    step's dim rows of a tile (the blocks stream them on their own), the
    seeds, the table, the counts and the candidates."""
    NO = (bm.shape[0] - 1) // 2
    steps = int(bm[2 * NO].long().sum())
    pairs = steps * TILE
    nbytes = (steps * dim * TILE * 4 + Q * 8 * 4 + bm.numel() * 4
              + (1 + Q + 3 * candidates) * 4)
    ops_per_pair = (3 * dim - 1) + SWEEP_COMPARES_PER_PAIR
    return pairs, (pairs * ops_per_pair, nbytes)


def rescue_check(records, mapper, signals, cfg, dev):
    """Phase 3, the rescue's search: the exact engine runs the first read
    with the mapper's card search, which answers each chunk; every chunk's
    answer equals the k-d tree's (windows and f32 distances a query), and on
    the first chunk the kernel, launched through its wrapper on the block
    table the card search builds, equals its plain version (counts exactly,
    candidates as a set) and is timed against its bound; the rotation's
    rounding on its candidates is measured against EPS."""
    import numpy as np
    import torch

    from sigmap_tpu_torch.mapping import rescue as RS
    from sigmap_tpu_torch.ops import rescue_search as RK
    from sigmap_tpu_torch.oracle import Oracle

    t0 = time.perf_counter()
    oracle = Oracle(mapper.index, cfg)
    tree_s = time.perf_counter() - t0
    card = mapper._card_search()
    assert card is not None, "the mapper has no card search"
    asked = []

    def search(q, radius_sq, per_cap):
        got = card(q, radius_sq, per_cap)
        asked.append((q.copy(), radius_sq, per_cap, got))
        return got

    oracle.streaming_read(signals[0].pa, search)
    assert asked, "the first read asked for no search"
    for q, radius_sq, per_cap, got in asked:
        want = oracle.tree.radius_batch(q, radius_sq, per_cap=per_cap)
        assert got is not None, "the card search left a chunk to the tree"
        qi = np.repeat(np.arange(len(q)), want[2])
        og, ow = np.lexsort((got[0], qi)), np.lexsort((want[0], qi))
        assert np.array_equal(got[2], want[2]) and np.array_equal(
            got[0][og], want[0][ow]) and np.array_equal(
            got[1][og].view(np.int32), want[1][ow].view(np.int32)), \
            "the card search's answer differs from the k-d tree's"

    q, radius_sq = asked[0][0], asked[0][1]
    st, dim, nq = mapper.store, mapper.index.dim, len(q)
    radius_c = radius_sq * (1 + RS.EPS)
    span = RS.probe_span(radius_c, st.cell_width)
    NO = span ** (len(st.radixes) - 1)
    table = np.zeros(nq * (8 + 2 * NO + 1), np.int32)
    words, rows = RS.block_table(q, st, card.host, radius_c, span, NO, table)
    t = torch.from_numpy(table).to(dev)
    seeds = t[:nq * 8].view(torch.float32).view(nq, 8)
    bm = t[nq * 8:words].view(2 * NO + 1, nq)
    counts = torch.zeros(1 + nq, dtype=torch.int32, device=dev)
    RK.rescue_search(seeds, bm, st.tiles, radius_c, dim, counts)
    n_cand = int(counts[0])
    out = torch.zeros(1 + nq + 3 * n_cand, dtype=torch.int32, device=dev)

    def canon(o):
        cand = o[1 + nq:].view(-1, 3)
        key = cand[:, 0].long() * nq + cand[:, 1].long()
        return o[:1 + nq].clone(), cand[torch.argsort(key)]

    def plain():
        o = torch.zeros_like(out)
        RK.rescue_search_plain(seeds, bm, st.tiles, radius_c, dim, o)
        return canon(o)

    RK.rescue_search(seeds, bm, st.tiles, radius_c, dim, out)
    got = canon(out)
    pairs, work = rescue_work(bm, nq, st.tile, dim, n_cand)
    steps = int(bm[2 * NO].long().sum())
    rec = check(records, "rescue_search",
                f"Q={nq} NO={NO} tile_steps={steps} candidates={n_cand}",
                got, lambda: RK.rescue_search(seeds, bm, st.tiles, radius_c,
                                              dim, out), plain,
                work=work)

    # each candidate's d^2 in the index's own basis, as kd_radius_rec sums
    cand = got[1].cpu().numpy()
    V = np.lib.stride_tricks.sliding_window_view(
        np.ascontiguousarray(mapper.index.values, np.float32), dim)
    diff = V[st.perm[cand[:, 0]]] - q[rows[cand[:, 1]]]
    d2 = diff[:, 0] * diff[:, 0]
    for d in range(1, dim):
        d2 = d2 + diff[:, d] * diff[:, d]
    rounding = float(np.abs(cand[:, 2].view(np.float32) - d2).max()
                     / radius_sq) if len(cand) else 0.0
    matches = int((d2 < np.float32(radius_sq)).sum())
    assert matches == len(asked[0][3][0]), \
        "the kernel's candidates hold other matches than the card search's"
    rec.update(seeds=nq, probe_offsets=NO, tile_steps=steps,
               pair_evals=pairs, candidates=n_cand, matches=matches,
               rotation_rounding=rounding, eps=RS.EPS,
               chunks_held_to_tree=len(asked), tree_build_s=tree_s,
               ptxas=ptxas_summary("rescue_search"))
    log(f"rescue_search: {len(asked)} chunks of the first read equal the k-d "
        f"tree's answer (tree built in {tree_s:.1f} s); first chunk "
        f"{nq} seeds, {NO} probe offsets, {steps} tile steps, {pairs} pair-"
        f"evaluations, {n_cand} candidates, {matches} matches; kernel "
        f"{rec['ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}) = {100 * rec['bound_ms'] / rec['ms']:.1f}% of "
        f"bound; the rotation's rounding {rounding:.3e} of the radius "
        f"(EPS {RS.EPS}); ptxas: {rec['ptxas']}")
    assert rounding * 100 <= RS.EPS, \
        "the rotation's rounding is not 100 times under EPS"


def sweep_adversarial(dim, TILE, K, block, seed=0):
    """B3 inputs (numpy: seeds [Q, 8], blockmeta, tiles, meta, radius) that
    stress the closest-K drain: a tenth of the windows on a 0.25 grid, so
    grid seeds meet many exactly equal distances within and across row
    groups; a quarter of tile 3 on one point, so block 1's seeds there have
    more candidates in one tile than the kernel's sparse list holds (ties at
    d^2 = 0); block 2 made only of SEED_PAD seeds; a block with no tile;
    store padding windows; three tile ranges per block, some empty."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T, G, lv = 8, 6, np.float32(0.25)
    tiles = np.zeros((T, 8, TILE), np.float32)
    cont = rng.normal(0, 1, (T, dim, TILE)).astype(np.float32)
    grid = rng.integers(-1, 2, (T, dim, TILE)).astype(np.float32) * lv
    on_grid = rng.random((T, 1, TILE)) < 0.1
    tiles[:, :dim] = np.where(on_grid, grid, cont)
    crowd = np.full(dim, lv, np.float32)
    lanes = rng.choice(TILE, TILE // 4, replace=False)
    tiles[3, :dim, lanes] = crowd
    tiles[T - 1, 0, TILE - TILE // 8:] = 1.0e30        # store padding
    meta = np.arange(T * TILE, dtype=np.int32).reshape(T, 8, TILE // 8)
    seeds = np.zeros((G * block, 8), np.float32)
    seeds[:block, :dim] = rng.integers(-1, 2, (block, dim)) * lv
    seeds[block:2 * block, :dim] = crowd
    seeds[block + block // 2:2 * block, :dim] = rng.integers(
        -1, 2, (block - block // 2, dim)) * lv
    seeds[2 * block:3 * block, :dim] = SEED_PAD
    seeds[3 * block:, :dim] = rng.normal(0, 0.5, (block * (G - 3), dim))
    # per block: tiles [s0, s0 + c0), [s1, s1 + c1), [s2, s2 + c2) (NO = 3;
    # empty ranges as the merged offsets of prepare_round leave them)
    ranges = [(0, 3, 4, 0, 4, 2), (2, 3, 5, 0, 6, 2), (0, 4, 4, 4, 0, 0),
              (1, 0, 1, 2, 5, 3), (0, 1, 3, 0, 7, 1), (0, 0, 0, 0, 0, 0)]
    bm = np.zeros((7, G), np.int32)
    for g, (s0, c0, s1, c1, s2, c2) in enumerate(ranges):
        bm[:, g] = (s0, s1, s2, 0, c0, c0 + c1, c0 + c1 + c2)
    return seeds, bm, tiles, meta, 0.13


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int):
    """Median milliseconds of fn() over reps runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(pairs):
    """Largest |kernel - plain| over pairs of tensors (exact match -> 0)."""
    err = 0.0
    for k, p in pairs:
        if k.shape != p.shape or k.dtype != p.dtype:
            raise AssertionError(f"shape/dtype {k.shape} {k.dtype} vs "
                                 f"{p.shape} {p.dtype}")
        d = (k.double() - p.double()).abs()
        if d.numel():
            err = max(err, float(d.max()))
    return err


def check(records, name, shape, got, kernel, plain, plain_reps=2, sub=None,
          work=None):
    """Kernel outputs `got` (tuple) vs plain(); time kernel() and plain().
    plain_reps=0 times the one checking run of plain() instead (for plain
    versions that take many seconds).  work=(ops, bytes) gives the bound.
    The record goes to records[name], or to records[name][sub] for a
    further shape of the same kernel.  No single PyTorch call computes any
    of these kernels' functions, so library_ms is null."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = plain()
    b.record()
    torch.cuda.synchronize()
    err = max_abs_err(list(zip(got, want)))
    rec = dict(max_abs_err=err, shape=shape, ms=cuda_ms(kernel, 5),
               plain_ms=(cuda_ms(plain, plain_reps) if plain_reps
                         else a.elapsed_time(b)), library_ms=None)
    if work is not None:
        rec.update(bound(*work))
    if sub is None:
        records.setdefault(name, {}).update(rec)
        rec = records[name]
    else:
        records.setdefault(name, {})[sub] = rec
    log(f"{name} {shape}: max_abs_err {err} kernel {rec['ms']:.3f} ms "
        f"plain {rec['plain_ms']:.3f} ms" + (
            f" bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            if work is not None else ""))
    assert err == 0.0, f"{name} kernel disagrees with its plain version"
    return rec


def write_reads(sig, reads):
    """Simulated reads -> `sig`/reads.blow5 (zlib records)."""
    from sigmap_tpu_torch.io.slow5 import COMP_ZLIB, SIGCOMP_NONE, write_blow5

    os.makedirs(sig, exist_ok=True)
    write_blow5(
        os.path.join(sig, "reads.blow5"),
        [dict(read_id=r.read_id, raw=r.raw, digitisation=r.digitisation,
              range=r.range, offset=r.offset) for r in reads],
        rec_comp=COMP_ZLIB, sig_comp=SIGCOMP_NONE,
    )


def make_workload(work, genome_bases, n_reads):
    """Genome FASTA, pore model and BLOW5 reads in `work`; returns reads."""
    from sigmap_tpu_torch.io.pore_model import make_synthetic_pore_model
    from sigmap_tpu_torch.synth import (genome_to_fasta_str, random_genome,
                                  simulate_reads)

    os.makedirs(work, exist_ok=True)
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(genome_bases, seed=SEED)
    with open(os.path.join(work, "ref.fa"), "w") as f:
        f.write(genome_to_fasta_str(genome))
    pore.save(os.path.join(work, "pore.model"))
    reads = simulate_reads(pore, genome, n_reads, seed=SEED + 1,
                           read_bases=READ_BASES)
    write_reads(os.path.join(work, "signals"), reads)
    return reads


def first_batch(map_args, dev, params=None):
    """The mapper of the `-m` arguments on `dev` (with TurboParams `params`,
    default the operating point), the feature stages of the first batch's
    first head block, and the batch's features, as the main path's
    functions build them: (mapper, signals, cfg, fs, n_full, clen, feats
    [B, NC, F], counts [B, NC])."""
    from sigmap_tpu_torch.cli import build_parser, make_config
    from sigmap_tpu_torch.index.build import SignalIndex
    from sigmap_tpu_torch.io.signals import load_all_read_signals
    from sigmap_tpu_torch.mapping import turbo as T
    from sigmap_tpu_torch.signal import events as EV

    args = build_parser().parse_args(map_args)
    cfg = make_config(args)
    m = cfg.mapping
    idx = SignalIndex.load(args.ref_index)
    signals = load_all_read_signals(args.sig_dir, m.pa_lo, m.pa_hi)
    mapper = T.TurboMapper(idx, cfg, params, device=dev)
    p = mapper.p
    qd, qoff, qscale, n_full, _ = mapper.upload_batch(
        signals[: cfg.runtime.read_batch])
    rows = T.head_inputs(qd, qoff, qscale, n_full)
    size = T.head_blocks(rows[0].shape[0], mapper._head_block)[0][1]
    q, qo, qs, clen = T.padded_block([t[:size] for t in rows], size)
    fs = EV.feature_stages(T.dequantize(q, qo, qs), clen, cfg.event,
                           p.max_events, p.max_features, m.compress_delta)
    feats, counts = T.batch_features(qd, qoff, qscale, n_full, p, cfg.event,
                                     m.compress_delta, mapper._head_block)
    return mapper, signals, cfg, fs, n_full, clen, feats, counts


def round0_sweep(mapper, feats, counts, n_full, cfg):
    """B3's inputs for round 0 of the batch, as the main path prepares
    them: (seeds, blockmeta, keyword arguments)."""
    from sigmap_tpu_torch.mapping import turbo as T
    from sigmap_tpu_torch.mapping.sweep_search import (longest_first,
                                                       prepare_round)

    m, p, s = cfg.mapping, mapper.p, mapper.store
    B = feats.shape[0]
    dim = mapper.index.dim
    st = T.init_round_state(B, p.RING, feats.device)
    seeds = T.round_seeds(feats[:, 0], counts[:, 0], n_full, st, p,
                          m.step_size, dim, m)[2]
    qr_s, bm, _ = longest_first(*prepare_round(
        seeds.reshape(B * p.S, 8), s.cum, s.tiles.shape[0], s.rot, s.mu,
        s.origin, m.search_radius, p.TILE, dim, p.block, s.radixes,
        s.span, s.cell_width), p.block)
    kw = dict(radius=m.search_radius, K=p.K, TILE=p.TILE, dim=dim,
              block=p.block)
    return qr_s, bm, kw


def chain_check(records, shape, args4, kw, sub=None, plain_reps=2):
    """B4 on `args4` (chain_fused's nine tensors) with keywords `kw` (the
    kernel's window_rows among them) against the plain version, timed, with
    chain_counts' valid anchors and slot tests, the bound, the window the
    kernel took the reads in and its shared memory (held to the CUDA
    source's twin)."""
    from sigmap_tpu_torch import _build
    from sigmap_tpu_torch.ops import chain_fused as CF

    def flat(out):      # (sum_f, sum_i, carry ring arrays) -> one tuple
        return (out[0], out[1], *out[2])

    A, B = args4[3].shape
    CARRY = args4[4].shape[0]
    ring, kb = kw["ring"], kw["kb"]
    plain_kw = {k: v for k, v in kw.items() if k != "window_rows"}
    cc = chain_counts(args4[0], args4[3], CARRY, ring, kb,
                      kw["cfg"].max_target_gap_length)
    ops, nbytes = chain_work(cc, A, B, CARRY, ring)
    W = CF.check_fits(A, CARRY, ring, kb, kw.get("window_rows"))
    smem = CF.shared_memory_bytes(A, CARRY, ring, kb, W)
    assert smem == _build.kernels().sig_chain_fused_smem(
        A, CARRY, ring, kb, W), "B4 shared-memory twin"
    rec = check(records, "chain_fused", shape,
                flat(CF.chain_fused(*args4, **kw)),
                lambda: CF.chain_fused(*args4, **kw),
                lambda: flat(CF.chain_fused_plain(*args4, **plain_kw)),
                sub=sub, work=(ops, nbytes), plain_reps=plain_reps)
    # the earlier counts, so that earlier runs' bounds stay comparable:
    # a whole test for every filled slot, and for all RING slots
    rec.update(cc, window_rows=W,
               windows_per_read=-(-(A - CARRY) // W) if W else 1,
               smem_bytes_per_read=smem,
               scratch_bytes=B * A * 16 if W else 0, **{
                   f"bound_ms_whole_test_{k}": bound(
                       cc[c] * CHAIN_OPS_PER_SLOT, nbytes)["bound_ms"]
                   for k, c in (("filled_slots", "slot_tests"),
                                ("all_slots", "slot_tests_all_slots"))})
    log(f"chain_fused {shape}: {cc}; window {W or 'whole read'} "
        f"({rec['windows_per_read']} a read, {smem} B shared memory a read, "
        f"{rec['scratch_bytes']} B scratch); bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}; {CHAIN_OPS_PER_REFUSAL} ops a refused test, "
        f"{CHAIN_OPS_PER_SLOT} a test in the anchor's target window) = "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of bound; at "
        f"{CHAIN_OPS_PER_SLOT} ops for every filled slot "
        f"{rec['bound_ms_whole_test_filled_slots']:.4f} ms, for all RING "
        f"slots {rec['bound_ms_whole_test_all_slots']:.4f} ms")
    return rec


def chain_rounds(mapper, cfg, feats, counts, n_full):
    """B4's inputs in the batch's rounds 0 (an empty carry) and 1 (round
    0's carry), as the main path builds them: ((args0, args1), A)."""
    from sigmap_tpu_torch.mapping import turbo as T

    m, p, idx, s = cfg.mapping, mapper.p, mapper.index, mapper.store
    B, NC = counts.shape
    st = T.init_round_state(B, p.RING, feats.device)

    def round_args(st, r):
        ra = T.round_anchors(s, feats[:, r], counts[:, r], n_full, st, p,
                             m.step_size, m.search_radius, idx.dim, m)
        return (ra.a_t, ra.a_q, ra.a_d, ra.a_g,
                *(x.contiguous() for x in st.carry[3:]))

    args0 = round_args(st, 0)
    st, _, _ = T.turbo_round(
        s, feats[:, 0], counts[:, 0], n_full, st, p, m.step_size,
        m.search_radius, idx.dim, cfg.chain, m)
    return (args0, round_args(st, 1 % NC)), args0[0].shape[0]


def compare_kernels(map_args, records, dev):
    """Phase 3: every kernel vs its plain version on the inputs that the
    main path's functions give it for the first batch.  Returns the mapper
    and the reads (phase 5 maps them again)."""
    import numpy as np
    import torch

    from sigmap_tpu_torch.ops import sweep_kernel as SK
    from sigmap_tpu_torch.signal import events_kernels as EK

    mapper, signals, cfg, fs, n_full, clen, feats, counts = first_batch(
        map_args, dev)
    m, p, idx = cfg.mapping, mapper.p, mapper.index
    R, Cs = fs.t1.shape

    # --- B1 / B2 on the first head block's chunk rows ----------------------
    ec, delta = cfg.event, m.compress_delta
    check(records, "peaks", f"R={R} C={Cs}", (fs.emits,),
          lambda: (EK.detect_peaks(fs.t1, fs.t2, clen, ec),),
          lambda: (EK.detect_peaks_plain(fs.t1, fs.t2, clen, ec),),
          plain_reps=0, work=peaks_work(R, Cs))
    copies = sum(not (x.is_contiguous() and x.dtype == torch.float32)
                 for x in (fs.t1, fs.t2))
    records["peaks"].update(wrapper_layout_copies=copies,
                            ptxas=ptxas_summary("events"))
    log(f"peaks wrapper: {copies} layout copies on the main path's rows (the "
        f"kernel reads [R, C] and writes [R, 2C] as they are, so the time "
        f"above holds no layout work); ptxas: {records['peaks']['ptxas']}")
    a1, a2, a_len = (torch.from_numpy(a).to(dev) for a in peaks_adversarial())
    for C_adv, sub in ((a1.shape[1], "adversarial"),
                       (a1.shape[1] // 4 * 4, "adversarial_unpadded")):
        b1, b2 = a1[:, :C_adv].contiguous(), a2[:, :C_adv].contiguous()
        b_len = a_len.clamp(max=C_adv)
        check(records, "peaks", f"adversarial R={b1.shape[0]} C={C_adv}",
              (EK.detect_peaks(b1, b2, b_len, ec),),
              lambda: (EK.detect_peaks(b1, b2, b_len, ec),),
              lambda: (EK.detect_peaks_plain(b1, b2, b_len, ec),),
              sub=sub, work=peaks_work(*b1.shape))
    # the last rows again as a contiguous view 4 bytes off a 16-byte boundary
    off = torch.cat([b1.new_zeros(1), b1.reshape(-1)])[1:].view(b1.shape)
    assert off.data_ptr() % 16 and off.is_contiguous()
    assert torch.equal(EK.detect_peaks(off, b2, b_len, ec),
                       EK.detect_peaks(b1, b2, b_len, ec)), \
        "B1 disagrees on a view off a 16-byte boundary"
    check(records, "compress_keep", f"R={R} E={p.max_events}",
          (fs.keep,),
          lambda: (EK.compress_keep(fs.norm, fs.num_events, delta),),
          lambda: (EK.compress_keep_plain(fs.norm, fs.num_events, delta),),
          work=keep_work(R, p.max_events))
    copies = int(not (fs.norm.is_contiguous()
                      and fs.norm.dtype == torch.float32
                      and fs.norm.shape[1] % 4 == 0))
    assert fs.keep.is_contiguous() and fs.keep.shape == fs.norm.shape, \
        "B2 must return a contiguous [R, E] mask"
    records["compress_keep"].update(wrapper_layout_copies=copies)
    log(f"compress_keep wrapper: {copies} layout copies on the main path's "
        f"rows (the kernel reads [R, E] and writes the [R, E] mask as they "
        f"are: no transpose)")
    k_norm, k_n, k_delta = (torch.from_numpy(a).to(dev) if i < 2 else a
                            for i, a in enumerate(compress_adversarial()))
    for E_adv, sub in ((k_norm.shape[1], "adversarial"),
                       (k_norm.shape[1] // 4 * 4, "adversarial_unpadded")):
        kn = k_norm[:, :E_adv].contiguous()
        check(records, "compress_keep",
              f"adversarial R={kn.shape[0]} E={E_adv}",
              (EK.compress_keep(kn, k_n, k_delta),),
              lambda: (EK.compress_keep(kn, k_n, k_delta),),
              lambda: (EK.compress_keep_plain(kn, k_n, k_delta),),
              sub=sub, work=keep_work(*kn.shape))

    # --- B3 on round 0's seeds, against the whole tile store ---------------
    B = feats.shape[0]
    qr_s, bm, kw = round0_sweep(mapper, feats, counts, n_full, cfg)
    s = mapper.store
    G = bm.shape[1]
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    full = SK.sweep_search(qr_s, bm, s.tiles, s.meta, overflow=ovf, **kw)
    ms_full = cuda_ms(lambda: SK.sweep_search(qr_s, bm, s.tiles, s.meta,
                                              **kw), 3)
    # radius 0 matches nothing: the distance pass, staging and barriers alone
    ms_no_match = cuda_ms(lambda: SK.sweep_search(
        qr_s, bm, s.tiles, s.meta, **dict(kw, radius=0.0)), 3)
    pairs, b_full = sweep_work(bm, p.TILE, p.block, idx.dim, p.K)
    steps = bm[-1].float()        # tile steps per block
    ns = min(G, SWEEP_BLOCKS)
    pick = np.sort(np.random.default_rng(SEED).choice(G, ns, replace=False))
    pick = torch.from_numpy(pick).to(dev)
    sub_seeds = qr_s.view(G, p.block, 8)[pick].reshape(-1, 8).contiguous()
    sub_bm = bm[:, pick].contiguous()
    rows = tuple(o.view(G, p.block, -1)[pick].reshape(ns * p.block, -1)
                 for o in full)
    rec = check(records, "sweep", f"Q={B * p.S} G={G} sampled_blocks={ns}",
                rows,
                lambda: SK.sweep_search(sub_seeds, sub_bm, s.tiles, s.meta,
                                        **kw),
                lambda: SK.sweep_search_plain(sub_seeds, sub_bm, s.tiles,
                                              s.meta, **kw), plain_reps=0)
    rec.update(sweep_work(sub_bm, p.TILE, p.block, idx.dim, p.K)[1])
    rec.update(ms_full_round=ms_full, ms_full_round_no_match=ms_no_match,
               pair_evals_full_round=pairs, overflow_full_round=int(ovf),
               tile_steps_per_block_mean=float(steps.mean()),
               tile_steps_per_block_max=int(steps.max()),
               **{f"{k}_full_round": v for k, v in b_full.items()})
    log(f"sweep full round Q={B * p.S}: {pairs} pair-evaluations; tile "
        f"steps per block mean {rec['tile_steps_per_block_mean']:.1f} max "
        f"{rec['tile_steps_per_block_max']}; kernel {ms_full:.3f} ms, "
        f"{ms_no_match:.3f} ms at radius 0 (no candidate to drain); bound "
        f"{b_full['bound_ms']:.3f} ms ({b_full['bound_by']}: "
        f"{b_full['bound_ops']} ops, {b_full['bound_bytes']} bytes) = "
        f"{100 * b_full['bound_ms'] / ms_full:.1f}% of bound; dense-path "
        f"drains (sparse list overflow) {int(ovf)}")

    # --- B3 on adversarial blocks: ties, list overflow, padding seeds ------
    adv = {}
    for dim in (1, 6, 8):
        arrs = sweep_adversarial(dim, p.TILE, p.K, p.block)
        a_s, a_bm, a_t, a_m = (torch.from_numpy(a).to(dev) for a in arrs[:4])
        akw = dict(kw, radius=arrs[4], dim=dim)
        a_ovf = torch.zeros(1, dtype=torch.int32, device=dev)
        got = SK.sweep_search(a_s, a_bm, a_t, a_m, overflow=a_ovf, **akw)
        err = max_abs_err(list(zip(got, SK.sweep_search_plain(
            a_s, a_bm, a_t, a_m, **akw))))
        adv[dim] = dict(max_abs_err=err, overflow=int(a_ovf),
                        max_cnt=int(got[2][:, 0].max()))
        log(f"sweep adversarial dim={dim}: max_abs_err {err}, dense-path "
            f"drains {int(a_ovf)}, most matches of a seed "
            f"{adv[dim]['max_cnt']}")
        assert err == 0.0, f"B3 disagrees on the adversarial set, dim {dim}"
        assert int(a_ovf) > 0, "the adversarial set took no dense path"
    rec["adversarial"] = adv
    rec["ptxas"] = ptxas_summary("sweep")
    log(f"sweep ptxas: {rec['ptxas']}")

    # --- B4: round 0 (empty carry), round 1 on round 0's carry, adversarial --
    ckw = dict(radius=m.search_radius, dim=idx.dim, ring=p.RING,
               cfg=cfg.chain, kb=p.K)
    (args0, args1), A = chain_rounds(mapper, cfg, feats, counts, n_full)
    chain_check(records, f"round 0 A={A} B={B} RING={p.RING} kb={p.K}",
                args0, ckw, sub="round0")
    rec = chain_check(records, f"A={A} B={B} RING={p.RING} kb={p.K}", args1,
                      ckw)
    rec.update(ptxas=ptxas_summary("chain_fused"))
    log(f"chain_fused ptxas: {rec['ptxas']}")
    adv_args, adv_kw = chain_adversarial()
    adv_args = tuple(torch.from_numpy(a).to(dev) for a in adv_args)
    nb = adv_args[0].shape[1]
    for kb in (1, 4, 8):
        chain_check(records, f"adversarial B={nb} RING=16 kb={kb}", adv_args,
                    dict(adv_kw, cfg=cfg.chain, kb=kb),
                    sub=f"adversarial_kb{kb}")
    for kb in (1, 4, 8, 16):
        chain_check(records, f"adversarial B={nb} RING=16 kb={kb} in windows "
                    f"of {ADV_WINDOW_ROWS}", adv_args,
                    dict(adv_kw, cfg=cfg.chain, kb=kb,
                         window_rows=ADV_WINDOW_ROWS),
                    sub=f"adversarial_windows_kb{kb}")

    # --- the rescue's search on a main-path rescue chunk --------------------
    rescue_check(records, mapper, signals, cfg, dev)
    return mapper, signals


def ptxas_summary(stem):
    """{kernel instantiation: 'N registers, N bytes static shared memory, N
    bytes stack, N bytes spill stores, N bytes spill loads'} from the
    build's ptxas -v output."""
    from sigmap_tpu_torch import _build

    out, fn = {}, None
    for line in _build.BUILD_LOG.get(stem, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = ""
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] += (f"{m.group(1)} B stack, {m.group(2)} B spill stores, "
                        f"{m.group(3)} B spill loads; ")
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m and fn:
            out[fn] += f"{m.group(1)} registers; "
            if m.group(2):
                out[fn] += f"{m.group(2)} B static shared memory; "
        m = re.search(r"(\d+) bytes lmem", line)
        if m and fn:
            out[fn] += f"{m.group(1)} B lmem; "
    return out


def _union(spans):
    """Sorted disjoint intervals covering the (start, end) pairs."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy(trace_path):
    """(busy ms, {name: (ms, count)}) of the device work in a chrome trace;
    busy time is the union of the intervals, so overlap counts once."""
    with open(trace_path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy = sum(b - a for a, b in _union((e["ts"], e["ts"] + e["dur"])
                                        for e in ev))
    by_name: dict = {}
    for e in ev:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1000, n + 1)
    return busy / 1000, by_name


def host_gaps(trace_path, top=10):
    """Where the device waits in a chrome trace: the gaps between device
    intervals (kernel, memcpy, memset; overlapping intervals merged), with
    the stretch before the first interval and the one after the last (the
    window runs from the first to the last event of the trace, the
    profiler's own span among them).  Returns
    the number of gaps, their sum, the host ops (torch.profiler CPU ops and
    CUDA runtime calls; nested ops each count, so they overlap) by the time
    they ran inside any gap, and the `top` longest gaps: for each its
    length, the device work on either side, its three longest host ops, and
    the share of the gap in which any such op ran (the rest is Python or
    native host code between ops)."""
    import bisect

    with open(trace_path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e.get("cat") in DEVICE_CATS)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
            if e.get("cat") in ("cpu_op", "cuda_runtime")]
    t0 = min(e["ts"] for e in ev)
    t1 = max(e["ts"] + e["dur"] for e in ev)
    gaps, end, last = [], t0, "(start of the pass)"
    for a, b, name in dev + [(t1, t1, "(end of the pass)")]:
        if a > end:
            gaps.append((end, a, last, name))
        if b > end:
            end, last = b, name
    starts = [g[0] for g in gaps]
    per_gap = [[] for _ in gaps]          # (lo, hi, name) clipped to the gap
    for a, b, name in host:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(gaps) and gaps[i][0] < b:
            lo, hi = max(a, gaps[i][0]), min(b, gaps[i][1])
            if hi > lo:
                per_gap[i].append((lo, hi, name))
            i += 1
    all_ops: dict = {}
    for spans in per_gap:
        for lo, hi, name in spans:
            all_ops[name] = all_ops.get(name, 0.0) + (hi - lo)
    out = []
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    for i in order[:top]:
        g0, g1, before, after = gaps[i]
        by_op: dict = {}
        covered, e0 = 0.0, g0
        for lo, hi, name in sorted(per_gap[i]):
            by_op[name] = by_op.get(name, 0.0) + (hi - lo)
            if hi > e0:
                covered += hi - max(lo, e0)
                e0 = hi
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:3]
        out.append(dict(gap_ms=(g1 - g0) / 1000, after=before[:60],
                        before=after[:60],
                        host_ops=[(n[:60], t / 1000) for n, t in ops],
                        host_op_share=covered / (g1 - g0)))
    return dict(
        n_gaps=len(gaps), gap_ms=sum(b - a for a, b, _, _ in gaps) / 1000,
        host_ops=[(n[:60], t / 1000) for n, t in
                  sorted(all_ops.items(), key=lambda kv: -kv[1])[:top]],
        longest=out)



def _overlap(u, v):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(u) and j < len(v):
        lo, hi = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        total += max(0.0, hi - lo)
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_overlap(trace_path, side_names, main_names, n_batches,
                   per_batch=1):
    """How long two CUDA streams' device work ran at once, batch by batch,
    in a chrome trace.  The side stream is the one that ran a kernel whose
    name holds side_names[0] (B1), the main stream the one that ran one
    holding main_names[0] (B3).  A batch's head runs ``per_batch``
    side_names[0] kernels (one a head block), so the side stream must hold
    n_batches * per_batch of them; its intervals (kernels, copies,
    memsets) split into n_batches bursts, per_batch such kernels each, at
    the longest gap between the last such kernel of one batch and the
    first of the next (the longest gaps of the whole stream can both fall
    inside one batch's head, whose host round trip and glue are not evenly
    spaced).  For each burst: its
    device time, the time it ran together with any main-stream work, and
    the time its kernels named in side_names ran together with main-stream
    kernels named in main_names, in ms, and its number of side_names[0]
    kernels."""
    with open(trace_path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]

    def stream_of(names):
        found = {e["args"]["stream"] for e in ev if e.get("cat") == "kernel"
                 and names[0] in e["name"]}
        if len(found) != 1:
            raise AssertionError(f"{names[0]} ran on streams {found}")
        return found.pop()

    side_id, main_id = stream_of(side_names), stream_of(main_names)
    if side_id == main_id:
        raise AssertionError(f"the overlap is not there: {side_names[0]} and "
                             f"{main_names[0]} ran on one stream {side_id}")

    def spans(stream, names=None):
        return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                if e.get("args", {}).get("stream") == stream and (
                    names is None or (e.get("cat") == "kernel" and any(
                        n in e["name"] for n in names)))]

    side = sorted(spans(side_id))
    main_all = _union((a, b) for a, b, _ in spans(main_id))
    main_named = _union((a, b) for a, b, _ in spans(main_id, main_names))
    marks = [i for i, (_, _, n) in enumerate(side) if side_names[0] in n]
    if len(marks) != n_batches * per_batch:
        raise AssertionError(
            f"the side stream's bursts are not one a batch: {len(marks)} "
            f"{side_names[0]} for {n_batches} batches of {per_batch}")
    lasts, firsts = marks[per_batch - 1::per_batch], marks[per_batch::per_batch]
    cuts = [0, *(max(range(f0 + 1, f1 + 1),
                     key=lambda i: side[i][0] - side[i - 1][1])
                 for f0, f1 in zip(lasts, firsts)), len(side)]
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        burst = side[lo:hi]
        u = _union((a, b) for a, b, _ in burst)
        named = _union((a, b) for a, b, n in burst
                       if any(m in n for m in side_names))
        out.append(dict(
            side_ms=sum(b - a for a, b in u) / 1000,
            overlap_ms=_overlap(u, main_all) / 1000,
            named_overlap_ms=_overlap(named, main_named) / 1000,
            first_kernels=sum(side_names[0] in n for _, _, n in burst)))
    return dict(side_stream=side_id, main_stream=main_id, per_batch=out)


@contextlib.contextmanager
def sweep_round_stats(rounds, inputs):
    """While active, every sweep round appends (blocks, blocks made only of
    SEED_PAD seeds, tile steps, tile steps of those blocks, TILE * block)
    to `rounds`, and B3's inputs in cell-key block order (seeds, blockmeta,
    perm, keyword arguments but K) to `inputs`; the counts are read once, when
    the context ends."""
    import inspect

    import torch

    from sigmap_tpu_torch.mapping import sweep_search as SS

    orig = SS.prepare_round
    sig = inspect.signature(orig)
    pending = []

    def wrapped(*a, **k):
        out = orig(*a, **k)
        arg = sig.bind(*a, **k).arguments
        seeds, block = arg["seeds"], arg["block"]
        bm, perm = out[1], out[2]
        G = bm.shape[1]
        pad = torch.ones(perm.shape[0], dtype=torch.bool, device=bm.device)
        pad[:seeds.shape[0]] = seeds[:, 0] == SEED_PAD
        blk_pad = pad[perm].view(G, block).all(dim=1)
        steps = bm[-1].long()
        pending.append((G, blk_pad.sum(), steps.sum(), steps[blk_pad].sum(),
                        arg["TILE"] * block))
        inputs.append((out[0], bm, perm, dict(
            radius=arg["radius"], TILE=arg["TILE"], dim=arg["dim"],
            block=block)))
        return out

    SS.prepare_round = wrapped
    try:
        yield rounds
    finally:
        SS.prepare_round = orig
        rounds.extend(tuple(int(x) for x in r) for r in pending)


def profile_warm(mapper, signals, work):
    """Phase 5: the reads mapped again once the rescue oracle is built: the
    sweep's statistics on an eager pass, then warm passes with the graphs
    on and off in turns, and one pass of each way under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sigmap_tpu_torch.mapping.sweep_search import longest_first
    from sigmap_tpu_torch.ops import sweep_kernel as SK

    t0 = time.perf_counter()
    mapper._get_oracle()
    oracle_s = time.perf_counter() - t0
    rounds, inputs = [], []
    # the statistics wrap prepare_round, which only an eager round calls
    # (a replay runs the captured kernels without Python)
    eager = eager_pass(mapper, signals, lambda: sweep_round_stats(
        rounds, inputs))
    tot = [0, 0, 0.0, 0.0]
    for i, ((G, G_pad, steps, steps_pad, tile_x_block),
            (qr_s, bm, perm, kw)) in enumerate(zip(rounds, inputs)):
        kw = dict(kw, K=mapper.p.K, tiles=mapper.store.tiles,
                  meta=mapper.store.meta)
        q_l, bm_l, _ = longest_first(qr_s, bm, perm, kw["block"])
        ms_long = cuda_ms(lambda: SK.sweep_search(q_l, bm_l, **kw), 3)
        ms_key = cuda_ms(lambda: SK.sweep_search(qr_s, bm, **kw), 3)
        tot[0] += steps * tile_x_block
        tot[1] += steps_pad * tile_x_block
        tot[2] += ms_long
        tot[3] += ms_key
        log(f"sweep round {i}: {G} blocks ({G_pad} all SEED_PAD), {steps} "
            f"tile steps ({steps_pad} in padding blocks), "
            f"{steps * tile_x_block} pair-evaluations "
            f"({steps_pad * tile_x_block} in padding blocks); B3 "
            f"{ms_long:.3f} ms longest first, {ms_key:.3f} ms in cell-key "
            f"order")
    log(f"sweep rounds of the batch: {tot[0]} pair-evaluations, "
        f"{tot[1]} in padding blocks = {100 * tot[1] / max(tot[0], 1):.4f}%; "
        f"B3 {tot[2]:.3f} ms longest first, {tot[3]:.3f} ms in cell-key "
        f"order")
    del inputs
    # three passes each way: the spread of a host-bound time; the untimed
    # pass captures the graphs
    walls = warm_set(mapper, signals, "phase 5", attr="_graphs", want=eager)
    stats = graph_log("warm", mapper)
    assert all(s["replays"] > 0 for s in stats), \
        "warm: a graph of the mapper was never replayed"
    n = len(signals)
    warm_s = statistics.median(walls[True])
    log(f"warm: rescue oracle build {oracle_s:.3f} s; streaming_map of {n} "
        f"reads with the graphs {warm_s:.3f} s = {n / warm_s:.3f} reads/s "
        f"(the median of three passes: "
        + ", ".join(f"{n / w:.3f}" for w in walls[True]) + ")")
    # the pass ends by waiting for the reads that the host's exact engine
    # re-maps (no torch op runs meanwhile): the mapper times that wait, so
    # that the stretch after the last device interval has a name
    for graphs in (True, False):
        mapper._graphs = graphs
        way = "graphs" if graphs else "eager"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mapper.streaming_map(signals)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        drain_ms = pass_waits(mapper.last_pass)["rescue_tail_ms"]
        n_rounds = round_host_ms(mapper.last_pass)["rounds"]
        trace = os.path.join(work, f"warm_trace_{way}.json")
        prof.export_chrome_trace(trace)
        busy_ms, by_name = device_busy(trace)
        log(f"warm profile ({way}): wall {prof_s * 1000:.3f} ms, device "
            f"busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / (prof_s * 1000):.4f}; waiting for the rescued "
            f"reads at the end of the pass {drain_ms:.3f} ms; {n_rounds} "
            "rounds; rounds on the host "
            + json.dumps(round_host_ms(mapper.last_pass)))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        for name, (ms, cnt) in top:
            log(f"  device {ms:10.3f} ms {cnt:6d}x  {name[:70]}")
        # the trace holds the kernels a graph launched, one B3 and one B4 a
        # round
        for kernel in ("sweep_kernel", "chain_fused_kernel"):
            cnt = sum(c for name, (_, c) in by_name.items() if kernel in name)
            assert cnt == n_rounds, (
                f"warm profile ({way}): {cnt} {kernel} in the trace for "
                f"{n_rounds} rounds")
        log_gaps(f"warm profile ({way})", trace)
    mapper._graphs = True


def eager_pass(mapper, signals, context=contextlib.nullcontext):
    """The mapper's records of `signals` with its rounds and heads run op
    by op (``_graphs`` False), inside ``context()``."""
    import torch

    graphs = mapper._graphs
    mapper._graphs = False
    try:
        with context():
            recs = mapper.streaming_map(signals)
        torch.cuda.synchronize()
    finally:
        mapper._graphs = graphs
    return recs


def graph_log(label, mapper):
    """Print each of the mapper's graphs (its captures, their host ms, its
    replays, its pool's MiB, the launches a replay adds) and return them
    (``TurboMapper.graph_stats``)."""
    stats = mapper.graph_stats()
    for s in stats:
        log(f"{label}: graph {s['graph']}: {s['captures']} capture(s) in "
            f"{s['capture_ms']:.3f} ms, {s['replays']} replays, pool "
            f"{s['pool_mib']:.1f} MiB, launches a replay "
            + json.dumps(s["launches_a_replay"]))
    return stats


def round_host_ms(stamps):
    """A pass's rounds on the host clock (``last_pass["round_host"]``: each
    round's seconds until its device work was sent and until its host
    signal came back) -> the rounds and the medians in ms."""
    rh = stamps["round_host"]
    return dict(rounds=len(rh),
                sent_ms=statistics.median(a for a, _ in rh) * 1000,
                back_ms=statistics.median(b for _, b in rh) * 1000)


def log_gaps(label, trace):
    """Print host_gaps of a trace: all of it as JSON, then the gaps."""
    gaps = host_gaps(trace)
    log(f"{label}, device gaps: " + json.dumps(gaps))
    log(f"  {gaps['n_gaps']} gaps, {gaps['gap_ms']:.3f} ms in all; host ops "
        f"inside them (nested ops each count): " + ", ".join(
            f"{n} {t:.3f} ms" for n, t in gaps["host_ops"]))
    for g in gaps["longest"]:
        log(f"  gap {g['gap_ms']:9.3f} ms after [{g['after']}] before "
            f"[{g['before']}]: host ops " + ", ".join(
                f"{n} {t:.3f} ms" for n, t in g["host_ops"])
            + f"; ops cover {g['host_op_share']:.2f} of the gap")


ALIGN_LINE = re.compile(
    r"Read name: (\S+), reference name: (\S+)\n"
    r"DTW distance: ([^,]+), (?:mapping_end_position: (-?\d+)\.|"
    r"feature_mapping_end_position: (-?\d+), "
    r"rough mapping end postion: (-?\d+)\.)")


def sdtw_shape(records, sub, args, plain_reps=0, label=""):
    """B5 == plain on `args`, timed, with its bound (and the bound at the
    instructions this card issues, `bound_ms_4op`), cell updates/s and
    plan; the same inputs == and timed under plan's other choices of rows a
    lane and CTAs a pair (`alternatives`).  Returns the kernel's
    outputs."""
    import torch

    from sigmap_tpu_torch.ops.sdtw_kernel import (CLUSTERS, ROWS, make_plan,
                                                  plan, sdtw, sdtw_plain,
                                                  sm_count)

    B, T = args[0].shape
    Q = args[2].shape[1]
    got = sdtw(*args)
    ops, nbytes = sdtw_work(args[1], args[3], T, Q)
    rec = check(records, "sdtw", f"{label}B={B} T={T} Q={Q}", got,
                lambda: sdtw(*args), lambda: sdtw_plain(*args),
                plain_reps=plain_reps, sub=sub, work=(ops, nbytes))
    cells = int((args[1].long() * args[3].long()).sum())
    sms = sm_count(args[0].device)
    pl = plan(B, T, Q, sms)
    rec.update(cell_updates_per_s=cells / (rec["ms"] / 1e3),
               bound_ms_4op=bound(cells * SDTW_INSTR_PER_CELL,
                                  nbytes)["bound_ms"],
               plan=pl._asdict())
    log(f"sdtw {label}B={B} T={T} Q={Q}: {cells} cells, "
        f"{rec['cell_updates_per_s']:.6e} cell updates/s; "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of the 5-op bound, "
        f"{100 * rec['bound_ms_4op'] / rec['ms']:.1f}% of the "
        f"{rec['bound_ms_4op']:.4f} ms 4-instruction bound; plan: "
        f"{pl.rows} rows a lane, {pl.warps} warps a CTA, {pl.cluster} CTAs "
        f"a cluster, {pl.ctas} CTAs, {pl.passes} passes, "
        f"{pl.scratch_bytes} B scratch, {pl.smem_bytes} B shared a CTA")
    alt = {}
    for R, C in sorted({(R, pl.cluster) for R in ROWS} |
                       {(pl.rows, C) for C in CLUSTERS}):
        if (R, C) == (pl.rows, pl.cluster) or (C > 1 and B * C > 2 * sms):
            continue
        try:
            other = make_plan(B, T, Q, R, C)
        except ValueError:
            continue
        alt_got = sdtw(*args, launch=other)
        assert all(torch.equal(a, b) for a, b in zip(alt_got, got)), \
            f"sdtw under {other} differs"
        alt[f"R{R}_C{C}"] = dict(warps=other.warps, passes=other.passes,
                                 ms=cuda_ms(lambda: sdtw(*args, launch=other),
                                            3))
    rec["alternatives"] = alt
    log(f"sdtw {label}alternatives (rows R, cluster C: ms): " + ", ".join(
        f"{k} {v['ms']:.3f}" for k, v in alt.items()))
    return got


def debug_phase(records, by_path, dev, work):
    """Phase 6: B5 == plain at bench.py's DTW shape and on the inputs of
    debug_modes' own pair preparation, the two align modes and the two
    dumps through the CLI."""
    import numpy as np
    import torch

    from sigmap_tpu_torch.config import EventDetectorConfig
    from sigmap_tpu_torch.io.signals import load_all_read_signals
    from sigmap_tpu_torch import LAUNCHES, cli, debug_modes, reset_launches
    from sigmap_tpu_torch.mapping.driver import whole_read_rows
    from sigmap_tpu_torch.ops.sdtw_kernel import sdtw, sdtw_plain
    from sigmap_tpu_torch.signal.events import feature_stages

    # --- B5 at bench.py:bench_dtw's shape ----------------------------------
    B, T, Q = DTW_SHAPE
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.normal(0, 1, (B, T)).astype(np.float32)),
            torch.full((B,), T, dtype=torch.int32),
            torch.from_numpy(rng.normal(0, 1, (B, Q)).astype(np.float32)),
            torch.full((B,), Q, dtype=torch.int32))
    sdtw_shape(records, "bench_dtw", tuple(a.to(dev) for a in args),
               plain_reps=2)
    records["sdtw"]["ptxas"] = ptxas_summary("sdtw")
    log(f"sdtw ptxas: {records['sdtw']['ptxas']}")
    for name, (launch, arrays) in sdtw_adversarial().items():
        args = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        check(records, "sdtw", f"adversarial {name}",
              sdtw(*args, launch=launch), lambda: sdtw(*args, launch=launch),
              lambda: sdtw_plain(*args), plain_reps=0,
              sub=f"adversarial_{name}")

    # --- the debug path's own inputs, all pairs, full width -----------------
    t0 = time.perf_counter()
    reads = make_workload(work, DEBUG_GENOME, DEBUG_READS)
    ref, pore, sig = (os.path.join(work, x)
                      for x in ("ref.fa", "pore.model", "signals"))
    log(f"debug workload: {DEBUG_GENOME} bases, {len(reads)} reads x "
        f"{READ_BASES} bases ({time.perf_counter() - t0:.1f} s)")
    truth = {r.read_id: r for r in reads}
    for mode, prep in (("dtw-align", debug_modes.dtw_pairs),
                       ("cwt-align", debug_modes.cwt_pairs)):
        t0 = time.perf_counter()
        labels, targets, queries = prep(ref, pore, sig)[:3]
        log(f"{mode} pairs: {time.perf_counter() - t0:.3f} s on the host "
            f"(signals, reference, features)")
        assert debug_modes.batch_bounds(
            targets, queries, torch.cuda.get_device_properties(
                dev).multi_processor_count) == [(0, len(targets))], \
            "the pairs should fit one batch"
        args = debug_modes.pack_pairs(targets, queries, dev)
        got = sdtw_shape(records, None if mode == "dtw-align" else "cwt_align",
                         args, label=f"{mode} pairs={len(targets)} ")
        walls = []      # three runs: one wall on a shared host is noisy
        for rep in range(3):
            reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(buf):
                rc = cli.main(["--debug-mode", mode, "-r", ref, "-p", pore,
                               "-s", sig])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            assert rc == 0, f"{mode} failed ({rc})"
            if rep == 0:
                by_path[mode] = dict(LAUNCHES)
        wall = statistics.median(walls)
        lines = ALIGN_LINE.findall(buf.getvalue())
        assert [(m[0], m[1]) for m in lines] == labels, \
            f"{mode}: {len(lines)} lines for {len(labels)} pairs"
        ends = [int(m[3] or m[4]) for m in lines]
        assert ends == got[1].cpu().tolist(), f"{mode}: ends differ"
        assert min(ends) >= 1, f"{mode}: an end position < 1"
        # sanity figure: the end's reference position inside the simulated
        # locus +- 10, forward-strand reads (the reference is forward only)
        pos = [e - 1 if not m[5] else int(m[5]) for e, m in zip(ends, lines)]
        fwd = [(truth[m[0]], p) for m, p in zip(lines, pos)
               if truth[m[0]].strand == 1]
        inside = sum(r.ref_start - 10 <= p <= r.ref_end + 10 for r, p in fwd)
        log(f"{mode} via CLI: {len(lines)} lines in {wall:.3f} s (median; "
            f"runs {', '.join(f'{w:.3f}' for w in walls)}); sdtw "
            f"launches {by_path[mode]['sdtw']}; forward-strand reads ending "
            f"inside their locus +-10: {inside}/{len(fwd)}")
        assert by_path[mode]["sdtw"] > 0, f"{mode} did not launch B5"

    # --- the two dumps of the same reads ------------------------------------
    prefix = os.path.join(work, "dump")
    for mode in ("events-to-text", "fast5-to-text"):
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--debug-mode", mode, "-s", sig, "-o", prefix])
        assert rc == 0, f"{mode} failed ({rc})"
        log(f"{mode}: {time.perf_counter() - t0:.1f} s")
    signals = load_all_read_signals(sig)
    with open(prefix + "_fast5") as f:
        n_fast5 = sum(1 for _ in f)
    n_samples = sum(len(s.pa) for s in signals)
    with open(prefix + "_event") as f:
        n_event = sum(1 for _ in f)
    # events per read from the port's device event stages on whole reads
    chunks, lengths = whole_read_rows(signals)
    E = chunks.shape[1] // 4
    st = feature_stages(torch.from_numpy(chunks).to(dev),
                        torch.from_numpy(lengths).to(dev),
                        EventDetectorConfig(), E, E)
    n_dev = int(st.num_events.sum())
    log(f"dumps: fast5-to-text {n_fast5} lines ({n_samples} samples); "
        f"events-to-text {n_event} lines (device event stages: {n_dev} "
        f"events)")
    assert n_fast5 == n_samples, "fast5-to-text: one line per sample"
    assert abs(n_event - n_dev) <= max(1, n_dev // 1000), \
        "events-to-text: line count off the event count"


def exact_phase(records, by_path, dev, work, reads, map_args):
    """Phase 7: -m --engine exact and -m --batch-mode through the CLI on
    phase 4's index, each on a prefix of phase 4's reads."""
    import torch

    from sigmap_tpu_torch.cli import build_parser, make_config
    from sigmap_tpu_torch.io.signals import load_all_read_signals
    from sigmap_tpu_torch import LAUNCHES, cli, reset_launches
    from sigmap_tpu_torch.mapping.driver import streaming_rows, whole_read_rows
    from sigmap_tpu_torch.signal import events_kernels as EK
    from sigmap_tpu_torch.signal.events import feature_stages

    for name, flag, n in (("exact", "--engine=exact", EXACT_READS),
                          ("batch-mode", "--batch-mode", BATCH_MODE_READS)):
        sub = reads[:n]
        sig = os.path.join(work, f"signals_{n}")
        write_reads(sig, sub)
        paf = os.path.join(work, f"{name}.paf")
        args = [*map_args, "-s", sig, "-o", paf, flag]
        # B1 / B2 on the path's first event rows, built as its Mapper does
        cfg = make_config(build_parser().parse_args(args))
        m, rt = cfg.mapping, cfg.runtime
        signals = load_all_read_signals(sig, m.pa_lo, m.pa_hi)
        if name == "exact":        # streaming_map's first wavefront
            first = [s for s in signals
                     if s.length // m.chunk_size][: rt.read_batch]
            chunks, lengths = streaming_rows(first, [0] * len(first),
                                             rt.read_batch, m.chunk_size)
            E, F_ = rt.max_events, rt.max_features
        else:                      # map_reads' first batch
            chunks, lengths = whole_read_rows(signals[: rt.read_batch])
            E = F_ = max(1024, chunks.shape[1] // 4)
        R, C = chunks.shape
        x = torch.from_numpy(chunks).to(dev)
        n_ = torch.from_numpy(lengths).to(dev)
        ec, delta = cfg.event, m.compress_delta
        fs = feature_stages(x, n_, ec, E, F_, delta)
        tag = name.replace("-", "_")
        check(records, "peaks", f"R={R} C={C}", (fs.emits,),
              lambda: (EK.detect_peaks(fs.t1, fs.t2, n_, ec),),
              lambda: (EK.detect_peaks_plain(fs.t1, fs.t2, n_, ec),),
              plain_reps=0, sub=tag, work=peaks_work(R, C))
        check(records, "compress_keep", f"R={R} E={E}", (fs.keep,),
              lambda: (EK.compress_keep(fs.norm, fs.num_events, delta),),
              lambda: (EK.compress_keep_plain(fs.norm, fs.num_events,
                                              delta),),
              plain_reps=0, sub=tag, work=keep_work(R, E))
        del x, n_, fs
        reset_launches()
        rc = cli.main(args)
        torch.cuda.synchronize()
        by_path[name] = dict(LAUNCHES)
        assert rc == 0, f"{name} mapping failed ({rc})"
        run = cli.LAST_MAP
        mapped, correct = score_paf(paf, sub)
        log(f"{name}: {run['reads']} reads in {run['map_s']:.3f} s = "
            f"{run['reads'] / run['map_s']:.3f} reads/s; mapped {mapped}/{n}"
            f", correct {correct}/{n}; launches {by_path[name]}")
        assert mapped >= 0.99 * n, f"{name}: only {mapped}/{n} reads mapped"
        assert correct >= 0.99 * n, \
            f"{name}: only {correct}/{n} reads mapped correctly"
        for k in ("peaks", "compress_keep"):
            assert by_path[name][k] > 0, f"{name} did not launch {k}"


def wide_phase(records, by_path, dev, work, reads, map_args, oracle):
    """Phase 8: the turbo path at TurboParams(S=1024, K=16): 768 carried
    and 16,384 new anchor rows a read, which B4 takes in windows (the
    parent refused the shape).  B4 == plain on round 0's and round 1's
    anchors of the first batch (all its reads), timed in the default
    windows (three blocks an SM) and in the largest; then streaming_map of the
    first WIDE_READS reads (read batch WIDE_READS), scored like phase 4.
    The mapper takes phase 5's rescue oracle (the same index and
    configuration) instead of building its own."""
    import dataclasses

    import torch

    from sigmap_tpu_torch import LAUNCHES, reset_launches
    from sigmap_tpu_torch.mapping import turbo as T
    from sigmap_tpu_torch.ops import chain_fused as CF

    params = T.TurboParams(**WIDE)
    t0 = time.perf_counter()
    mapper, signals, cfg, fs, n_full, _, feats, counts = first_batch(
        map_args, dev, params)
    B = feats.shape[0]
    log(f"wide: TurboMapper(S={params.S}, K={params.K}) and the first batch "
        f"in {time.perf_counter() - t0:.1f} s")
    m, p = cfg.mapping, mapper.p
    ckw = dict(radius=m.search_radius, dim=mapper.index.dim, ring=p.RING,
               cfg=cfg.chain, kb=p.K)
    args, A = chain_rounds(mapper, cfg, feats, counts, n_full)
    del fs, feats, counts
    big = CF.largest_window(p.RING, p.K)
    for r, a in enumerate(args):
        rec = chain_check(records, f"round {r} A={A} B={B} RING={p.RING} "
                          f"kb={p.K} (S={p.S})", a, ckw, sub=f"wide_round{r}",
                          plain_reps=0)
        want = CF.chain_fused(*a, **ckw)
        got = CF.chain_fused(*a, **ckw, window_rows=big)
        err = max_abs_err(list(zip((got[0], got[1], *got[2]),
                                   (want[0], want[1], *want[2]))))
        assert err == 0.0, "B4 differs between two window sizes"
        rec.update(window_rows_largest=big, ms_largest_window=cuda_ms(
            lambda: CF.chain_fused(*a, **ckw, window_rows=big), 5))
        smem = CF.shared_memory_bytes(A, p.RING, p.RING, p.K, big)
        log(f"chain_fused round {r} (S={p.S}): {rec['ms']:.3f} ms in the "
            f"default windows of {rec['window_rows']} rows (three blocks an "
            f"SM, {rec['smem_bytes_per_read']} B) against "
            f"{rec['ms_largest_window']:.3f} ms in the largest, {big} rows "
            f"({smem} B)")
    mapper.close()
    del mapper, args, signals
    torch.cuda.empty_cache()

    n = min(WIDE_READS, len(reads))
    sig = os.path.join(work, "signals_wide")
    write_reads(sig, reads[:n])
    from sigmap_tpu_torch.cli import build_parser, make_config
    from sigmap_tpu_torch.index.build import SignalIndex
    from sigmap_tpu_torch.io.signals import load_all_read_signals

    a = build_parser().parse_args(map_args)
    cfg = make_config(a)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, read_batch=n))
    mapper = T.TurboMapper(SignalIndex.load(a.ref_index), cfg, params,
                           device=dev, oracle=oracle)
    signals = load_all_read_signals(sig, cfg.mapping.pa_lo,
                                    cfg.mapping.pa_hi)
    reset_launches()
    t0 = time.perf_counter()
    recs = mapper.streaming_map(signals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = by_path["turbo_wide"] = dict(LAUNCHES)
    mapped, correct = score_hits(
        {r.read_name: ("+" if r.direction == 1 else "-", r.fragment_start,
                       r.fragment_start + r.fragment_length)
         for r in recs if r.is_mapped}, reads[:n])
    log(f"wide turbo S={p.S} K={p.K}: {n} reads in {wall:.3f} s = "
        f"{n / wall:.3f} reads/s; mapped {mapped}/{n}, correct {correct}/{n};"
        f" rescued {mapper.n_rescued} ({mapper.n_rescued_mapped} mapped); "
        f"launches {launches}")
    stats = graph_log("wide turbo", mapper)
    mapper.close()
    assert any(s["graph"].startswith("round") and s["replays"] > 0
               for s in stats), "wide turbo: the round graph never replayed"
    assert mapped >= 0.99 * n, f"wide: only {mapped}/{n} reads mapped"
    assert correct >= 0.99 * n, f"wide: only {correct}/{n} reads correct"
    for k in ("peaks", "compress_keep", "sweep", "chain_fused"):
        assert launches[k] > 0, f"wide turbo did not launch {k}"


def gpu_test_phase():
    """Phase 9: tests/test_torch_gpu.py on the card, as the README runs it
    (no conftest: tests/conftest.py imports jax).  Fails unless pytest
    exits 0 and its summary is only passes (no failure, error or skip)."""
    cmd = [sys.executable, "-m", "pytest", "-m", "gpu", "--noconftest", "-p",
           "no:cacheprovider", "-q", "tests/test_torch_gpu.py"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    lines = [x for x in r.stdout.splitlines() if x.strip()]
    summary = lines[-1].strip("= ") if lines else ""
    log(summary)
    ok = r.returncode == 0 and re.fullmatch(r"\d+ passed in \S+.*", summary)
    if not ok:
        log(r.stdout[-8000:])
        log(r.stderr[-4000:])
        raise AssertionError(f"gpu tests: rc {r.returncode}, {summary!r}")
    log(f"gpu tests: {time.perf_counter() - t0:.1f} s")


def records_without_mt(recs):
    """PAF records as dicts, their mt: timing tag left out."""
    out = [dataclasses.asdict(r) for r in recs]
    for r in out:
        r["tags"] = [t for t in r["tags"].split("\t") if t[:3] != "mt:"]
    return out


def pass_waits(stamps):
    """A pass's host-clock stamps (``TurboMapper.last_pass``) -> ms: the
    head (start to the first batch's rounds), the waits between batches'
    rounds, each batch's rounds, and the wait for the rescued reads."""
    rounds = stamps["rounds"]
    return dict(
        head_ms=(rounds[0][0] - stamps["start"]) * 1000,
        between_ms=[(b[0] - a[1]) * 1000 for a, b in zip(rounds, rounds[1:])],
        rounds_ms=[(b - a) * 1000 for a, b in rounds],
        rescue_tail_ms=(stamps["rescues"][1] - stamps["rescues"][0]) * 1000)


def warm_set(mapper, signals, label, gate=False, attr="_overlap_batches",
             want=None):
    """One untimed pass, then OVERLAP_PASSES warm passes with the mapper's
    switch ``attr`` (the cross-batch overlap, or the graphs) on and as many
    off, in turns (on, off, off, on, ...), each with its wall, reads/s,
    waits and its rounds' host time.  Fails if a pass's records differ
    apart from mt: from ``want`` (default: the first pass's), or, with
    ``gate``, if every pass of the mapper's default way was slower than
    every pass of the other way.  Returns the walls {True: [s, ...],
    False: [...]}."""
    import torch

    n = len(signals)
    what = {"_overlap_batches": "overlap", "_graphs": "graphs"}[attr]
    default = getattr(mapper, attr)

    def one_pass(on):
        setattr(mapper, attr, on)
        t0 = time.perf_counter()
        recs = mapper.streaming_map(signals)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, recs

    _, first = one_pass(default)                    # untimed
    want = records_without_mt(first if want is None else want)
    assert records_without_mt(first) == want, \
        f"warm ({label}): the untimed pass's records differ"
    walls = {True: [], False: []}
    for i in range(OVERLAP_PASSES):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            wall, recs = one_pass(on)
            walls[on].append(wall)
            same = records_without_mt(recs) == want
            log(f"warm ({label}), {what} {'on ' if on else 'off'}: "
                f"{wall:.3f} s = {n / wall:.3f} reads/s; records equal "
                f"apart from mt: {same}; "
                + json.dumps(pass_waits(mapper.last_pass))
                + "; rounds on the host "
                + json.dumps(round_host_ms(mapper.last_pass)))
            assert same, f"records differ with the {what} on and off"
    setattr(mapper, attr, default)
    for on in (True, False):
        w = walls[on]
        log(f"warm ({label}), {what} {'on' if on else 'off'}: median "
            f"{statistics.median(w):.3f} s = {n / statistics.median(w):.3f} "
            "reads/s (" + ", ".join(f"{n / x:.3f}" for x in w) + ")")
    assert not gate or min(walls[default]) <= max(walls[not default]), (
        f"warm ({label}): every pass of the default ({what} "
        f"{'on' if default else 'off'}) was slower than every pass of the "
        "other way")
    return walls


def three_batch_phase(by_path, dev, work, genome_bases, oracle):
    """Phase 10: the round-5 workload, THREE_BATCH_READS reads of phase 4's
    genome (the reads of phase 4 are its first ones: simulate_reads draws
    read by read) in batches of THREE_BATCH_B at HOST_THREADS host threads,
    on phase 4's index.  The CLI run first, then warm passes with the
    cross-batch overlap on and off on one mapper with phase 5's rescue
    oracle (`oracle`), and at -t 1 at smaller read batches, then one
    overlapped pass under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sigmap_tpu_torch import LAUNCHES, cli, reset_launches
    from sigmap_tpu_torch.cli import build_parser, make_config
    from sigmap_tpu_torch.index.build import SignalIndex
    from sigmap_tpu_torch.io.signals import load_all_read_signals
    from sigmap_tpu_torch.mapping import turbo as T

    t_phase = time.perf_counter()
    sub = os.path.join(work, "three_batch")
    reads = make_workload(sub, genome_bases, THREE_BATCH_READS)
    n = len(reads)
    n_batches = -(-n // THREE_BATCH_B)
    paf = os.path.join(sub, "out.paf")
    map_args = ["-m", "-r", os.path.join(sub, "ref.fa"),
                "-p", os.path.join(sub, "pore.model"),
                "-x", os.path.join(work, "idx"),
                "-s", os.path.join(sub, "signals"), "-o", paf,
                "--read-batch", str(THREE_BATCH_B), "-t", str(HOST_THREADS)]

    # --- through the CLI: its own tile store and rescue oracle (cold) ------
    reset_launches()
    rc = cli.main(map_args)
    torch.cuda.synchronize()
    launches = by_path["turbo3"] = dict(LAUNCHES)
    assert rc == 0, f"three batches: mapping failed ({rc})"
    run = cli.LAST_MAP
    mapped, correct = score_paf(paf, reads)
    log(f"three batches, CLI (-t {HOST_THREADS}, read batch {THREE_BATCH_B}"
        f"): {run['reads']} reads in {run['map_s']:.3f} s = "
        f"{run['reads'] / run['map_s']:.3f} reads/s; mapped {mapped}/{n}, "
        f"correct {correct}/{n}; rescued {run['rescued']} "
        f"({run['rescued_mapped']} mapped); launches {launches}")
    assert mapped >= 0.99 * n, f"three batches: only {mapped}/{n} mapped"
    assert correct >= 0.99 * n, f"three batches: only {correct}/{n} correct"
    for k in ("peaks", "compress_keep", "sweep", "chain_fused"):
        assert launches[k] > 0, f"three batches: {k} was not launched"

    # --- warm: the overlap on and off, alternated, on one mapper ----------
    a = build_parser().parse_args(map_args)
    cfg = make_config(a)
    index = SignalIndex.load(a.ref_index)
    mapper = T.TurboMapper(index, cfg, device=dev, oracle=oracle)
    signals = load_all_read_signals(a.sig_dir, cfg.mapping.pa_lo,
                                    cfg.mapping.pa_hi)
    batch = signals[:THREE_BATCH_B]
    NC = mapper.upload_batch(batch)[0].shape[1]
    blocks = len(T.head_blocks(THREE_BATCH_B * NC, mapper._head_block))
    assert launches["peaks"] == launches["compress_keep"] == \
        n_batches * blocks, "B1 and B2 are launched once a head block"
    # every timed pass replays the graphs and is held to an eager pass
    warm_set(mapper, signals, f"-t {HOST_THREADS}, read batch "
             f"{THREE_BATCH_B}", gate=True,
             want=eager_pass(mapper, signals))
    graph_log("three batches", mapper)
    # -t 1 at smaller read batches, the CLI's default first
    for B in SWEEP_BATCHES:
        small = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, read_batch=B, num_threads=1))
        small_mapper = T.TurboMapper(index, small, device=dev, oracle=oracle)
        label = f"-t 1, read batch {B}"
        warm_set(small_mapper, signals[:SWEEP_READS], label,
                 gate=B == SWEEP_BATCHES[0],
                 want=eager_pass(small_mapper, signals[:SWEEP_READS]))
        graph_log(label, small_mapper)
        small_mapper.close()

    # the head alone (batch 0; the rounds are not running): the host's
    # staging of the pA into the pinned buffer, and all of prepare_batch
    stage_ms, prep_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        T.stage_batch(batch, THREE_BATCH_B, NC, cfg.mapping.chunk_size,
                      cfg.mapping.max_num_chunks, pin=True)
        stage_ms.append((time.perf_counter() - t0) * 1000)
        t0 = time.perf_counter()
        mapper.prepare_batch(batch)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1000)
    log(f"three batches: batch 0's head alone (NC={NC}): stage_batch "
        + ", ".join(f"{x:.3f}" for x in stage_ms) + " ms; prepare_batch "
        + ", ".join(f"{x:.3f}" for x in prep_ms) + " ms")

    # --- one overlapped pass under the profiler ---------------------------
    mapper._overlap_batches = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.streaming_map(signals)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    tail_ms = pass_waits(mapper.last_pass)["rescue_tail_ms"]
    mapper.close()
    trace = os.path.join(work, "three_batch_trace.json")
    prof.export_chrome_trace(trace)
    busy_ms, by_name = device_busy(trace)
    log(f"three batches, profiled overlapped pass: wall {prof_s * 1000:.3f} "
        f"ms, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / (prof_s * 1000):.4f}; waiting for the last batch's "
        f"rescued reads at {HOST_THREADS} threads {tail_ms:.3f} ms")
    for name, (ms, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:10]:
        log(f"  device {ms:10.3f} ms {cnt:6d}x  {name[:70]}")
    log_gaps("three batches", trace)
    ov = stream_overlap(trace, ("peaks_kernel", "compress_keep_kernel"),
                        ("sweep_kernel", "chain_fused_kernel"), n_batches,
                        blocks)
    log("three batches, side stream (batch_features) against main stream "
        "(rounds), per batch: " + json.dumps(ov))
    for i, b in enumerate(ov["per_batch"]):
        log(f"  batch {i}: side-stream work {b['side_ms']:.3f} ms, of it "
            f"{b['overlap_ms']:.3f} ms at once with main-stream work; B1/B2 "
            f"at once with B3/B4 {b['named_overlap_ms']:.3f} ms")
    assert [b["first_kernels"] for b in ov["per_batch"]] == \
        [blocks] * n_batches, "the side stream's bursts are not one a batch"
    # this shows that the two streams do not serialise, not that a head
    # is hidden: warm_set's walls say that
    for i in range(1, n_batches):
        assert ov["per_batch"][i]["overlap_ms"] > 0, (
            f"the streams serialise: batch {i}'s head ran while no "
            f"main-stream work did")
    del mapper, signals
    torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")


def free_port():
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_shard_ranks(mesh, out_dir, args, wall_s=SHARD_WALL_S):
    """One process a rank of a D x I mesh, each running
    tests/_torch_shard_worker.py with `args` (its options but the rank,
    world, coordinator, mesh and output) and a wall limit of wall_s.
    Returns (what each rank wrote, wall s).  Fails if a rank fails or
    outlives its limit; the other ranks are then killed."""
    D, I = mesh
    world = D * I
    os.makedirs(out_dir, exist_ok=True)
    coord = f"localhost:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, SHARD_WORKER, "--rank", str(r), "--world",
         str(world), "--coordinator", coord, "--mesh", str(D), str(I),
         "--out-dir", out_dir, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=wall_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed ({p.returncode}):\n" \
            + out[-4000:]
    outs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs, wall


def shard_differences(label, want, want_pass, got, got_pass):
    """Records of the sharded mapper (`got`, its ``last_pass``) against the
    single-device mapper's on the same reads: every record equal apart
    from mt:, but for reads whose capacity overflowed (row 7 of rb_i) in
    either run; both runs rescue as many reads.  Prints and returns the
    counts."""
    a, b = records_without_mt(want), records_without_mt(got)
    assert len(a) == len(b), f"{label}: {len(b)} records for {len(a)}"
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    overflow = set(want_pass["overflow"]) | set(got_pass["overflow"])
    counts = dict(reads=len(a), differ=len(differ),
                  overflow_single=len(want_pass["overflow"]),
                  overflow_sharded=len(got_pass["overflow"]),
                  rescued_single=len(want_pass["rescued"]),
                  rescued_sharded=len(got_pass["rescued"]))
    log(f"{label}: records against the single-device mapper's: "
        + json.dumps(counts))
    assert set(differ) <= overflow, (
        f"{label}: records of reads that did not overflow differ: "
        f"{sorted(set(differ) - overflow)[:10]}")
    assert counts["rescued_sharded"] == counts["rescued_single"], \
        f"{label}: the sharded mapper rescued another number of reads"
    return counts


def shard_equal(label, want, want_pass, got, got_pass):
    """The sharded mapper's records (`got`, its ``last_pass``) against
    ``threaded_shard_map``'s for the same mesh: equal apart from mt:, no
    read exempt, and the same overflow and rescued reads."""
    a, b = records_without_mt(want), records_without_mt(got)
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    log(f"{label}: records against the one-process emulation of its mesh: "
        f"{len(b)} for {len(a)} reads, {len(differ)} differ")
    assert len(a) == len(b) and not differ, (
        f"{label}: records differ from the emulation's: {differ[:10]}")
    for k in ("overflow", "rescued"):
        assert sorted(want_pass[k]) == sorted(got_pass[k]), \
            f"{label}: other {k} reads than the emulation's"


def threaded_shard_map(index, cfg, params, n_index, signals, dev,
                       oracle=None, wait_s=300):
    """What the sharded mapper returns at any mesh (D, n_index), computed
    in this process without a process group: n_index TurboMappers, one on
    each tile shard of ``ShardedSweep``, run on as many threads in lock
    step.  Each round every thread puts its match slots beside the
    others', waits at a barrier, and merges them all with
    ``merge_shard_matches`` (what the index group's all-gather and sum
    hand it); only shard 0 rescues.  A read's record does not depend on
    the reads beside it in a batch, so the data axis needs no emulation.
    Returns shard 0's records and its ``last_pass``; a thread's fault
    breaks the barrier (or its wait_s limit does) and is raised here."""
    import threading

    import torch

    from sigmap_tpu_torch.mapping.turbo import TurboMapper
    from sigmap_tpu_torch.parallel.turbo_shard import (
        ShardedSweep, merge_shard_matches, tile_store_from_shard)

    ss = ShardedSweep.build(index, cfg.mapping.search_radius, n_index,
                            tile=params.TILE,
                            cache_dir=cfg.runtime.sweep_cache_dir)
    barrier = threading.Barrier(n_index, timeout=wait_s)
    slots = [None] * n_index

    class Shard(TurboMapper):
        def __init__(self, i):
            self.i = i
            super().__init__(
                index, cfg, dataclasses.replace(params, rescue=i == 0),
                device=dev, oracle=oracle)
            self._ovf_warned = i != 0
            self._overlap_batches = False
            self._graphs = False
            self._merge_matches = self._merge

        def _tile_store(self):
            return tile_store_from_shard(ss, self.i, self.device)

        def _merge(self, m_meta, m_d2, cnt, wrote):
            slots[self.i] = (m_meta, m_d2, wrote, cnt)
            barrier.wait()
            am, ad, aw, c = (torch.stack(x) for x in zip(*slots))
            out = merge_shard_matches(am, ad, aw, c.sum(0, dtype=c.dtype),
                                      params.K)
            barrier.wait()      # every shard has read the slots
            return out

    mappers = [Shard(i) for i in range(n_index)]
    results = [None] * n_index

    def run(i):
        try:
            results[i] = mappers[i].streaming_map(signals)
        except BaseException as e:
            results[i] = e
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_index)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for m in mappers:
        m.close()
    faults = [r for r in results if isinstance(r, BaseException)]
    if faults:
        # the fault itself before the broken barriers it left behind
        raise min(faults, key=lambda e: isinstance(
            e, threading.BrokenBarrierError))
    return results[0], mappers[0].last_pass


def shard_phase(by_path, dev, work, reads, map_args, oracle):
    """Phase 11: the sharded mapper on phase 4's index at the default
    TurboParams.  (a) world size 1 over NCCL in this process against the
    single-device mapper (both with phase 5's rescue oracle `oracle`), (b)
    two gloo ranks on the one card as subprocesses.  Both share one sweep
    cache, so the host's tile store is built once."""
    import torch
    import torch.distributed as dist

    from sigmap_tpu_torch import LAUNCHES, reset_launches
    from sigmap_tpu_torch.cli import build_parser, make_config
    from sigmap_tpu_torch.index.build import SignalIndex
    from sigmap_tpu_torch.io.signals import load_all_read_signals
    from sigmap_tpu_torch.mapping import turbo as T
    from sigmap_tpu_torch.parallel.multihost import initialize_distributed
    from sigmap_tpu_torch.parallel.turbo_shard import (ShardMesh,
                                                       TurboShardMapper)

    t_phase = time.perf_counter()
    a = build_parser().parse_args(map_args)
    cache = os.path.join(work, "sweep_cache")
    cfg = make_config(a)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, read_batch=SHARD_READS, sweep_cache_dir=cache))
    index = SignalIndex.load(a.ref_index)
    signals = load_all_read_signals(a.sig_dir, cfg.mapping.pa_lo,
                                    cfg.mapping.pa_hi)[:SHARD_READS]
    n = len(signals)
    single = T.TurboMapper(index, cfg, device=dev, oracle=oracle)

    # --- (a) world size 1, NCCL, in this process -------------------------
    rank, world = initialize_distributed(
        f"localhost:{free_port()}", 1, 0, backend="nccl",
        timeout=SHARD_PG_TIMEOUT_S)
    try:
        mesh = ShardMesh.create(1, 1, dev)
        sharded = TurboShardMapper(index, cfg, mesh, device=dev,
                                   oracle=oracle)
        merges = []                     # (start, end) events of each merge
        merge = sharded._merge_matches

        def timed_merge(*args):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = merge(*args)
            ev[1].record()
            merges.append(ev)
            return out

        sharded._merge_matches = timed_merge

        def one_pass(mapper):
            t0 = time.perf_counter()
            recs = mapper.streaming_map(signals)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, recs, dict(mapper.last_pass)

        _, want, want_pass = one_pass(single)          # untimed
        reset_launches()
        _, got, got_pass = one_pass(sharded)           # untimed
        launches = by_path["shard"] = dict(LAUNCHES)
        n_rounds = len(merges)
        shard_differences("sharded (1, 1), NCCL", want, want_pass, got,
                          got_pass)
        shard_equal("sharded (1, 1), NCCL", *threaded_shard_map(
            index, cfg, T.TurboParams(), 1, signals, dev, oracle), got,
            got_pass)
        walls = {"single": [], "sharded": []}
        for i in range(SHARD_PASSES):
            order = (("single", single), ("sharded", sharded))
            for name, mapper in (order if i % 2 == 0 else order[::-1]):
                merges.clear()
                wall, recs, p = one_pass(mapper)
                walls[name].append(wall)
                assert records_without_mt(recs) == records_without_mt(
                    want if name == "single" else got), \
                    f"{name}: a warm pass's records differ from the first's"
                if name == "sharded":
                    merge_ms = [s.elapsed_time(e) for s, e in merges]
        world_size = dist.get_world_size()
    finally:
        dist.destroy_process_group()
    mapped, correct = score_hits(
        {r.read_name: ("+" if r.direction == 1 else "-", r.fragment_start,
                       r.fragment_start + r.fragment_length)
         for r in got if r.is_mapped}, reads[:n])
    n_batches = -(-n // SHARD_READS)
    log(f"sharded (1, 1), NCCL, world size {world_size} (rank {rank}): "
        f"{n} reads, read batch {SHARD_READS}; mapped {mapped}/{n}, correct "
        f"{correct}/{n}; {n_rounds / n_batches:.1f} rounds a batch; "
        f"launches {launches}")
    for name, w in walls.items():
        log(f"sharded (1, 1), NCCL: warm {name}: median "
            f"{statistics.median(w):.3f} s = {n / statistics.median(w):.3f} "
            "reads/s (" + ", ".join(f"{n / x:.3f}" for x in w) + ")")
    log(f"sharded (1, 1), NCCL: merge (all-gather, sort, sum) a round, ms: "
        + ", ".join(f"{x:.3f}" for x in merge_ms)
        + f" (median {statistics.median(merge_ms):.3f}, of the last warm "
        "pass)")
    assert mapped >= 0.99 * n, f"sharded: only {mapped}/{n} reads mapped"
    assert correct >= 0.99 * n, f"sharded: only {correct}/{n} correct"
    for k in ("peaks", "compress_keep", "sweep", "chain_fused"):
        assert launches[k] > 0, f"the sharded path did not launch {k}"
    graph_log("sharded (1, 1), NCCL: single-device", single)
    stats = graph_log("sharded (1, 1), NCCL", sharded)
    assert [s["captures"] for s in stats if s["graph"].startswith(
        "round")] == [2], "the sharded round is not two graphs"
    assert all(s["replays"] > 0 for s in stats), \
        "sharded (1, 1): a graph was never replayed"
    sharded.close()
    del sharded

    # --- (b) two gloo ranks on the one card, as subprocesses -------------
    m = SHARD_GLOO_READS
    cfg_b = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, read_batch=m))
    single_b = T.TurboMapper(index, cfg_b, device=dev, oracle=oracle)
    want = single_b.streaming_map(signals[:m])
    torch.cuda.synchronize()
    want_pass = dict(single_b.last_pass)
    single.close()
    single_b.close()
    sig = os.path.join(work, "signals_shard")
    write_reads(sig, reads[:m])
    from sigmap_tpu_torch.io.paf import PAFRecord

    emulated = {}                 # n_index -> threaded_shard_map's
    for mesh_b in SHARD_GLOO_MESHES:
        outs, wall = run_shard_ranks(
            mesh_b, os.path.join(work, f"shard_{mesh_b[0]}x{mesh_b[1]}"),
            ["--backend", "gloo", "--device", "cuda", "--timeout",
             str(SHARD_PG_TIMEOUT_S), "--index", a.ref_index, "--signals",
             sig, "--read-batch", str(m), "--threads", "2",
             "--sweep-cache", cache, "--passes", str(SHARD_GLOO_PASSES)])
        recs = [[PAFRecord(**r) for r in o["records"]] for o in outs]
        assert all(r == recs[0] for r in recs), \
            f"mesh {mesh_b}: the ranks returned different records"
        assert sum(o["n_rescued_here"] for o in outs if o["i"]) == 0, \
            f"mesh {mesh_b}: a rank of index rank > 0 rescued reads"
        label = f"sharded {mesh_b}, gloo on one card"
        shard_differences(label, want, want_pass, recs[0], outs[0])
        if mesh_b[1] not in emulated:
            emulated[mesh_b[1]] = threaded_shard_map(
                index, cfg_b, T.TurboParams(), mesh_b[1], signals[:m], dev,
                oracle)
        shard_equal(label, *emulated[mesh_b[1]], recs[0], outs[0])
        passes = [max(x) for x in zip(*(o["map_s"] for o in outs))]
        log(f"{label}: {m} reads, read batch {m}, the slowest rank's "
            "streaming_map, pass by pass (the first cold, building the "
            "rescue oracle): " + ", ".join(
                f"{x:.3f} s = {m / x:.3f} reads/s" for x in passes)
            + "; set-up " + ", ".join(f"{o['setup_s']:.1f}" for o in outs)
            + f" s; the ranks' processes {wall:.1f} s in all; gloo stages "
            "each collective through the host, so this is no multi-GPU "
            "scaling figure")
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


def long_reads(genome_bases, pa_lo, pa_hi):
    """Phase 12's reads: LONG_READS reads, each with its own length drawn
    with numpy (seed SEED + 3) from a log-normal of median LONG_MEDIAN
    bases and sigma LONG_SIGMA, clipped to LONG_CLIP; LONG_OFF of them
    (named off_*) from a random genome of LONG_OFF_GENOME bases that is not
    indexed, the rest from phase 4's genome.  Returns (the on-target
    reads, the signals of all reads in order, their lengths in bases)."""
    import numpy as np

    from sigmap_tpu_torch.io.pore_model import make_synthetic_pore_model
    from sigmap_tpu_torch.io.signals import ReadSignal, dac_to_pa
    from sigmap_tpu_torch.synth import random_genome, simulate_read

    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(genome_bases, seed=SEED)
    other = random_genome(LONG_OFF_GENOME, seed=SEED + 4)
    rng = np.random.default_rng(SEED + 3)
    n = LONG_READS
    bases = np.clip(rng.lognormal(np.log(LONG_MEDIAN), LONG_SIGMA, n),
                    *LONG_CLIP).astype(np.int64)
    off = np.zeros(n, bool)
    off[rng.choice(n, round(LONG_OFF * n), replace=False)] = True
    reads = [simulate_read(pore, other if o else genome, rng,
                           f"{'off' if o else 'read'}_{i:05d}", int(b))
             for i, (b, o) in enumerate(zip(bases, off))]
    signals = [ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                          dac_to_pa(r.raw, r.digitisation, r.range, r.offset,
                                    pa_lo, pa_hi))
               for r in reads]
    return [r for r, o in zip(reads, off) if not o], signals, bases


def nan_equal(a, b):
    """Tensors equal element for element, NaN where both are NaN."""
    import torch

    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def head_block_tries(q, qoff, qscale, n_full, p, cfg, dev):
    """The head of one batch (q [B, NC, Cs]) through head graphs of each
    block size of HEAD_BLOCK_TRIES: its device ms (CUDA events, the median
    of three after one warm-up) and ms a row, and its graphs' pools.
    Returns {size: ms a row}."""
    import torch

    from sigmap_tpu_torch.mapping import turbo as T
    from sigmap_tpu_torch.mapping.graphs import HeadGraph

    B, NC, Cs = q.shape
    rows = B * NC
    args = (p, cfg.event, cfg.mapping.compress_delta)
    per_row = {}
    for size in HEAD_BLOCK_TRIES:
        made: dict = {}

        def run(sz, part):
            if sz not in made:
                made[sz] = HeadGraph(sz, Cs, *args, dev)
            return made[sz].run(*part)

        ms = cuda_ms(lambda: T.batch_features(q, qoff, qscale, n_full, *args,
                                              size, run), 3)
        per_row[size] = ms / rows
        blocks = [sz for _, sz in T.head_blocks(rows, size)]
        log(f"long reads: head block {size} rows at B={B}, NC={NC}: "
            f"{ms:.3f} ms = {ms / rows * 1000:.4f} us a row; blocks "
            f"{blocks}; pools "
            + ", ".join(f"{g.name} {g.stats()['pool_mib']:.1f} MiB"
                        for g in made.values()))
        del made, run
        torch.cuda.empty_cache()
    top = max(HEAD_BLOCK_TRIES)
    chosen = min(s for s in HEAD_BLOCK_TRIES
                 if per_row[s] <= 1.1 * per_row[top])
    log(f"long reads: the smallest head block within 10% of the largest's "
        f"ms a row: {chosen} (the mapper's HEAD_ROWS: {T.HEAD_ROWS})")
    return per_row


def long_read_phase(by_path, dev, work, genome_bases, oracle):
    """Phase 12: long mixed-length reads with off-target reads
    (``long_reads``) on phase 4's index at the default TurboParams, read
    batch LONG_BATCH, HOST_THREADS host threads, with the rescue oracle
    `oracle` (None: built at first need): an eager pass, then
    LONG_GRAPH_PASSES passes with the graphs whose records must equal it
    apart from mt:; on-target reads scored like phase 4, off-target ones
    mapped counted; the head's blocks and ms, and its ms at each of
    HEAD_BLOCK_TRIES; then the bucket sweep: a batch of the same reads cut
    to each chunk bucket, prepared with the graphs and held exactly to the
    whole batch's head run eagerly in one block, and the head graphs'
    pools after all ten buckets."""
    import numpy as np
    import torch

    from sigmap_tpu_torch import LAUNCHES, reset_launches
    from sigmap_tpu_torch.cli import build_parser, make_config
    from sigmap_tpu_torch.index.build import SignalIndex
    from sigmap_tpu_torch.io.signals import ReadSignal
    from sigmap_tpu_torch.mapping import turbo as T

    t_phase = time.perf_counter()
    cfg = make_config(build_parser().parse_args([
        "-m", "-r", os.path.join(work, "ref.fa"),
        "-p", os.path.join(work, "pore.model"),
        "-x", os.path.join(work, "idx"), "-s", os.path.join(work, "signals"),
        "-o", os.path.join(work, "long.paf"),
        "--read-batch", str(LONG_BATCH), "-t", str(HOST_THREADS)]))
    m = cfg.mapping
    Cs, B = m.chunk_size, LONG_BATCH
    index = SignalIndex.load(os.path.join(work, "idx"))
    t0 = time.perf_counter()
    reads, signals, bases = long_reads(genome_bases, m.pa_lo, m.pa_hi)
    n, n_on = len(signals), len(reads)
    chunks = np.array([s.length // Cs for s in signals])
    at_cap = int((chunks >= m.max_num_chunks).sum())
    log(f"long reads: {n} reads, {n - n_on} off-target, {bases.min()}-"
        f"{bases.max()} bases (median {np.median(bases):.0f}), median "
        f"{np.median(chunks):.1f} chunks, {at_cap} reach the "
        f"{m.max_num_chunks}-chunk cap; made in "
        f"{time.perf_counter() - t0:.1f} s")

    mapper = T.TurboMapper(index, cfg, device=dev, oracle=oracle)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = records_without_mt(eager_pass(mapper, signals))
    log(f"long reads, eager pass: {time.perf_counter() - t0:.3f} s; "
        + json.dumps(pass_waits(mapper.last_pass)))
    names = ("peaks", "compress_keep", "sweep", "chain_fused")
    blocks = T.head_blocks(B * T._nc_bucket(int(chunks.max()), m),
                           mapper._head_block)
    for i in range(LONG_GRAPH_PASSES):
        reset_launches()
        t0 = time.perf_counter()
        recs = mapper.streaming_map(signals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in names}
        if i == 0:
            by_path["long_reads"] = dict(LAUNCHES)
        lp = mapper.last_pass
        rescued = set(lp["rescued"])
        by_name = {r.read_name: ("+" if r.direction == 1 else "-",
                                 r.fragment_start,
                                 r.fragment_start + r.fragment_length)
                   for r in recs if r.is_mapped}
        mapped, correct = score_hits(by_name, reads)
        off_mapped = sum(k.startswith("off_") for k in by_name)
        off_rescued = sum(signals[j].read_id.startswith("off_")
                          for j in rescued)
        waits = pass_waits(lp)
        same = records_without_mt(recs) == want
        log(f"long reads, graphs, pass {i}: {wall:.3f} s = {n / wall:.3f} "
            f"reads/s; on-target mapped {mapped}/{n_on}, correct "
            f"{correct}/{n_on}; off-target mapped (false positives) "
            f"{off_mapped}/{n - n_on}; {len(lp['round_host'])} rounds a "
            f"batch; {at_cap} reads at the cap; overflow "
            f"{len(lp['overflow'])}, rescued {len(rescued)} "
            f"({off_rescued} off-target), their chunk searches "
            f"{LAUNCHES['rescue_search']} on the card; rescue tail "
            f"{waits['rescue_tail_ms']:.3f} ms; launches {launches}; "
            f"records equal the eager pass's apart from mt: {same}; "
            + json.dumps(waits))
        assert same, "long reads: the graphs' records differ from eager"
        assert correct >= 0.99 * n_on, \
            f"long reads: only {correct}/{n_on} on-target reads correct"
        assert all(launches[k] > 0 for k in names), launches
        assert LAUNCHES["rescue_search"] > 0 or not rescued, \
            "long reads: the rescued reads launched no rescue search"
        assert launches["peaks"] == launches["compress_keep"] == len(blocks), \
            f"long reads: B1/B2 {launches} for {len(blocks)} head blocks"
    log(f"long reads: device memory reserved at most "
        f"{torch.cuda.max_memory_reserved() / 2**20:.1f} MiB")

    # --- the head at B=2048, NC=30: its blocks and ms, and block sizes ------
    q, qoff, qscale, nf_d, _ = mapper.upload_batch(signals[:B])
    args = (mapper.p, cfg.event, m.compress_delta)
    rows = q.shape[0] * q.shape[1]
    head_ms = cuda_ms(lambda: T.batch_features(
        q, qoff, qscale, nf_d, *args, mapper._head_block,
        mapper._run_head_block), 3)
    log(f"long reads: the head at B={B}, NC={q.shape[1]} ({rows} rows) in "
        f"{len(blocks)} blocks {[sz for _, sz in blocks]}: {head_ms:.3f} ms "
        f"= {head_ms / rows * 1000:.4f} us a row")
    head_block_tries(q, qoff, qscale, nf_d, mapper.p, cfg, dev)
    del q, qoff, qscale, nf_d
    graph_log("long reads", mapper)

    # --- the bucket sweep: every chunk bucket at B=2048 --------------------
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    for NC in T._NC_BUCKETS:
        cut = [ReadSignal(s.read_id, s.digitisation, s.range, s.offset,
                          s.pa[:NC * Cs]) for s in signals[:B]]
        prep = mapper.prepare_batch(cut)
        q, qoff, qscale, nf_d, _ = mapper.upload_batch(cut)
        assert q.shape[1] == NC, (q.shape, NC)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        whole = T.batch_features(q, qoff, qscale, nf_d, *args, B * NC)
        b.record()
        torch.cuda.synchronize()
        same = (nan_equal(prep.feats, whole[0])
                and torch.equal(prep.counts, whole[1]))
        peak = torch.cuda.max_memory_reserved()
        ms = cuda_ms(lambda: T.batch_features(
            q, qoff, qscale, nf_d, *args, mapper._head_block,
            mapper._run_head_block), 3)
        nb = len(T.head_blocks(B * NC, mapper._head_block))
        log(f"long reads, bucket NC={NC}: {B * NC} rows, {nb} blocks, head "
            f"{ms:.3f} ms with the graphs, {a.elapsed_time(b):.3f} ms eager "
            f"in one block; equal to the one-block head: {same}; reserved "
            f"at most {peak / 2**20:.1f} MiB so far")
        assert same, f"long reads: the blocked head differs at NC={NC}"
        del prep, q, qoff, qscale, nf_d, whole
        torch.cuda.empty_cache()
    heads = [s for s in mapper.graph_stats() if s["graph"].startswith("head")]
    pools = sum(s["pool_mib"] for s in heads)
    after = torch.cuda.memory_reserved()
    mapper.close()
    log(f"long reads: after all ten buckets {len(heads)} head graphs ("
        + ", ".join(f"{s['graph']} {s['pool_mib']:.1f} MiB" for s in heads)
        + f"), {pools:.1f} MiB of pools in all; memory reserved "
        f"{before / 2**20:.1f} MiB before the sweep, {after / 2**20:.1f} "
        "MiB after")
    sizes = {mapper._head_block >> k
             for k in range(mapper._head_block.bit_length())}
    assert all(int(s["graph"].split()[1][5:]) in sizes for s in heads), heads
    assert pools <= HEAD_POOL_LIMIT_MIB, \
        f"long reads: head pools {pools:.1f} MiB"
    del mapper, signals
    torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


def score_paf(path, reads):
    """(mapped, correct) against the simulation truth (bench.py accuracy)."""
    by_name = {}
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            if int(c[11]) > 60:
                continue
            by_name[c[0]] = (c[4], int(c[7]), int(c[8]))
    return score_hits(by_name, reads)


def score_hits(by_name, reads):
    """(mapped, correct) of {read name: (strand, start, end)}."""
    mapped = correct = 0
    for r in reads:
        hit = by_name.get(r.read_id)
        if hit is None:
            continue
        mapped += 1
        strand, lo, hi = hit
        if (strand == "+") == (r.strand == 1) and lo < r.ref_end \
                and hi > r.ref_start:
            correct += 1
    return mapped, correct


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=float, default=12.0)
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2048)
    args = ap.parse_args()

    import torch

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        log("no CUDA device visible")
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from sigmap_tpu_torch import LAUNCHES, _build, cli, reset_launches

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"nvidia-smi: {card or smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.kernels()
    _build.native()
    log(f"build: kernels + native core {time.perf_counter() - t0:.1f} s")

    work = os.path.join(ROOT, "build", "chip_smoke")
    t0 = time.perf_counter()
    reads = make_workload(work, int(args.genome_mb * 1e6), args.reads)
    log(f"workload: {args.genome_mb} Mb genome, {len(reads)} reads x "
        f"{READ_BASES} bases ({time.perf_counter() - t0:.1f} s)")
    common = ["-r", os.path.join(work, "ref.fa"),
              "-p", os.path.join(work, "pore.model")]
    t0 = time.perf_counter()
    rc = cli.main(["-i", *common, "-o", os.path.join(work, "idx")])
    assert rc == 0, f"index build failed ({rc})"
    log(f"index: {time.perf_counter() - t0:.1f} s")

    paf = os.path.join(work, "out.paf")
    map_args = ["-m", *common, "-x", os.path.join(work, "idx"),
                "-s", os.path.join(work, "signals"), "-o", paf,
                "--read-batch", str(args.batch)]
    records: dict = {}
    by_path: dict = {}       # launches of each path, counted from 0
    dev = torch.device("cuda")
    mapper, signals = compare_kernels(map_args, records, dev)

    resident = torch.cuda.memory_allocated()      # phase 3's mapper
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rc = cli.main(map_args)
    torch.cuda.synchronize()
    launches = by_path["turbo"] = dict(LAUNCHES)
    assert rc == 0, f"mapping failed ({rc})"
    run = cli.LAST_MAP
    mapped, correct = score_paf(paf, reads)
    n = len(reads)
    rps = run["reads"] / run["map_s"]
    log(f"main path: {run['reads']} reads in {run['map_s']:.3f} s = "
        f"{rps:.3f} reads/s; mapped {mapped}/{n}, correct {correct}/{n}; "
        f"rescued {run['rescued']} ({run['rescued_mapped']} mapped); "
        f"device memory peak "
        f"{(torch.cuda.max_memory_allocated() - resident) / 2**20:.0f} MiB "
        f"(beyond phase 3's resident mapper); launches {launches}")
    for g in run["graphs"]:
        log(f"main path: graph {g['graph']}: {g['captures']} capture(s) in "
            f"{g['capture_ms']:.3f} ms, {g['replays']} replays, pool "
            f"{g['pool_mib']:.1f} MiB")
    assert mapped >= 0.99 * n, f"only {mapped}/{n} reads mapped"
    assert correct >= 0.99 * n, f"only {correct}/{n} reads mapped correctly"
    for name in ("peaks", "compress_keep", "sweep", "chain_fused"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the main path"
    # one batch: its head runs eagerly and is captured; its rounds after
    # the first replay the round graph
    assert any(g["graph"].startswith("round") and g["replays"] > 0
               for g in run["graphs"]), "the main path replayed no round"

    profile_warm(mapper, signals, work)
    mapper.close()
    oracle = mapper._get_oracle()
    del mapper, signals
    torch.cuda.empty_cache()

    debug_phase(records, by_path, dev, os.path.join(work, "debug"))
    exact_phase(records, by_path, dev, work, reads,
                ["-m", *common, "-x", os.path.join(work, "idx"),
                 "--read-batch", str(EXACT_READ_BATCH)])
    wide_phase(records, by_path, dev, work, reads, map_args, oracle)
    torch.cuda.empty_cache()
    gpu_test_phase()
    three_batch_phase(by_path, dev, work, int(args.genome_mb * 1e6), oracle)
    shard_phase(by_path, dev, work, reads, map_args, oracle)
    long_read_phase(by_path, dev, work, int(args.genome_mb * 1e6), oracle)
    del oracle
    assert sum(p["rescue_search"] for p in by_path.values()) > 0, \
        "no mapping path rescued a read through the card search"

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=sum(p[name] for p in by_path.values()),
             launches_by_path={k: p[name] for k, p in by_path.items()
                               if p[name]},
             **records[name])
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
