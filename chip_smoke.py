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
   and spills;
4. drives the main path through the CLI (``-i`` then ``-m``) on a synthetic
   genome with BLOW5 (zlib) reads, scores the PAF against the simulation
   truth, and checks that every kernel of the path was launched;
5. maps the reads again with the rescue oracle built (warm): the sweep's
   tile steps and pair-evaluations per round, split between blocks made
   only of SEED_PAD seeds and the rest, and each round's B3 time with the
   blocks longest first (the main path) and in cell-key order; reads/s,
   and under torch.profiler
   the device's busy time (union of its kernel, memcpy and memset
   intervals) and idle share;
6. the debug modes and B5: B5 == plain at bench.py's DTW shape and on the
   debug path's own full-width inputs (a 48,502-base reference, 64 reads of
   3000 bases), then ``--debug-mode dtw-align`` and ``cwt-align`` through
   the CLI (one line per pair, B5 launched), then the ``events-to-text``
   and ``fast5-to-text`` dumps of the same reads;
7. the exact engine through the CLI on phase 4's index: ``--engine exact``
   on the first EXACT_READS reads and ``--batch-mode`` on the first
   BATCH_MODE_READS, each scored like phase 4; B1/B2 == plain first on
   each path's own rows (the streaming wavefront's first chunks, batch
   mode's whole reads).

A line before the last is the per-kernel JSON record (each kernel's
launches, max_abs_err, ms, plain_ms, its bound from the operations and bytes
of this run's inputs, library_ms), the last line ``{"ok": true, "device":
{...}}``.  Any failure raises (non-zero exit, no result line).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
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
BATCH_MODE_READS = 128
EXACT_READ_BATCH = 512   # --read-batch of phase 7: one wavefront of reads

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
CHAIN_OPS_PER_SLOT = 25      # B4: one ring-slot test (the division as one)
SDTW_OPS_PER_CELL = 5        # B5: sub, abs, two mins, add per cell
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


def chain_work(a_g, ring, B):
    """B4: every valid new anchor tests the RING ring slots; the anchors,
    the carry and the carry-out rings, the summaries."""
    A = a_g.shape[0]
    n_valid = int((a_g[ring:] >= 0).sum())
    return (n_valid * ring * CHAIN_OPS_PER_SLOT,
            A * B * 16 + ring * B * 4 * (5 + 8) + B * 16 * 4)


def sdtw_work(t_len, q_len, T, Q):
    """B5: every cell of every pair; targets, queries and results."""
    B = t_len.shape[0]
    cells = int((t_len.long() * q_len.long()).sum())
    return cells * SDTW_OPS_PER_CELL, (B * (T + Q)) * 4 + B * 16


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


def first_batch(map_args, dev):
    """The mapper of the `-m` arguments on `dev` and the first batch's
    feature stages, as the main path's functions build them: (mapper,
    signals, cfg, fs, n_full, clen, (B, NC, Cs))."""
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
    mapper = T.TurboMapper(idx, cfg, device=dev)
    p = mapper.p
    qd, qoff, qscale, n_full, _ = mapper.upload_batch(
        signals[: cfg.runtime.read_batch])
    pa, clen = T.chunk_rows(qd, qoff, qscale, n_full)
    fs = EV.feature_stages(pa, clen, cfg.event, p.max_events,
                           p.max_features, m.compress_delta)
    return mapper, signals, cfg, fs, n_full, clen, tuple(qd.shape)


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


def compare_kernels(map_args, records, dev):
    """Phase 3: every kernel vs its plain version on the inputs that the
    main path's functions give it for the first batch.  Returns the mapper
    and the reads (phase 5 maps them again)."""
    import numpy as np
    import torch

    from sigmap_tpu_torch.mapping import turbo as T
    from sigmap_tpu_torch.ops import chain_fused as CF
    from sigmap_tpu_torch.ops import sweep_kernel as SK
    from sigmap_tpu_torch.signal import events_kernels as EK

    mapper, signals, cfg, fs, n_full, clen, (B, NC, Cs) = first_batch(
        map_args, dev)
    m, p, idx = cfg.mapping, mapper.p, mapper.index

    # --- B1 / B2 on the batch's chunk rows ---------------------------------
    ec, delta = cfg.event, m.compress_delta
    check(records, "peaks", f"R={B * NC} C={Cs}", (fs.emits,),
          lambda: (EK.detect_peaks(fs.t1, fs.t2, clen, ec),),
          lambda: (EK.detect_peaks_plain(fs.t1, fs.t2, clen, ec),),
          work=peaks_work(B * NC, Cs))
    check(records, "compress_keep", f"R={B * NC} E={p.max_events}",
          (fs.keep,),
          lambda: (EK.compress_keep(fs.norm, fs.num_events, delta),),
          lambda: (EK.compress_keep_plain(fs.norm, fs.num_events, delta),),
          work=keep_work(B * NC, p.max_events))

    # --- B3 on round 0's seeds, against the whole tile store ---------------
    feats = fs.feats.reshape(B, NC, -1)
    counts = fs.counts.reshape(B, NC)
    st = T.init_round_state(B, p.RING, dev)
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
                                              s.meta, **kw), plain_reps=1)
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

    # --- B4 on round 1's anchors and round 0's carry ------------------------
    st, _, _ = T.turbo_round(
        s, feats[:, 0], counts[:, 0], n_full, st, p, m.step_size,
        m.search_radius, idx.dim, cfg.chain, m)
    r1 = 1 % NC
    ra = T.round_anchors(s, feats[:, r1], counts[:, r1], n_full, st, p,
                         m.step_size, m.search_radius, idx.dim, m)
    c = [x.contiguous() for x in st.carry[3:]]
    ckw = dict(radius=m.search_radius, dim=idx.dim, ring=p.RING,
               cfg=cfg.chain, kb=p.K)
    args4 = (ra.a_t, ra.a_q, ra.a_d, ra.a_g, *c)

    def flat(out):      # (sum_f, sum_i, carry ring arrays) -> one tuple
        return (out[0], out[1], *out[2])

    check(records, "chain_fused",
          f"A={ra.a_t.shape[0]} B={B} RING={p.RING} kb={p.K}",
          flat(CF.chain_fused(*args4, **ckw)),
          lambda: CF.chain_fused(*args4, **ckw),
          lambda: flat(CF.chain_fused_plain(*args4, **ckw)),
          work=chain_work(ra.a_g, p.RING, B))
    return mapper, signals


def ptxas_summary(stem):
    """{kernel instantiation: 'N registers, N bytes stack, N bytes spill
    stores, N bytes spill loads'} from the build's ptxas -v output."""
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
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] += f"{m.group(1)} registers; "
        m = re.search(r"(\d+) bytes lmem", line)
        if m and fn:
            out[fn] += f"{m.group(1)} B lmem; "
    return out


def device_busy(trace_path):
    """(busy ms, {name: (ms, count)}) of the device work in a chrome trace;
    busy time is the union of the intervals, so overlap counts once."""
    with open(trace_path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in ev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in ev:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1000, n + 1)
    return busy / 1000, by_name


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
    """Phase 5: the reads mapped again once the rescue oracle is built."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sigmap_tpu_torch.mapping.sweep_search import longest_first
    from sigmap_tpu_torch.ops import sweep_kernel as SK

    t0 = time.perf_counter()
    mapper._get_oracle()
    oracle_s = time.perf_counter() - t0
    rounds, inputs = [], []
    with sweep_round_stats(rounds, inputs):
        mapper.streaming_map(signals)              # warm-up
    torch.cuda.synchronize()
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
    t0 = time.perf_counter()
    mapper.streaming_map(signals)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.streaming_map(signals)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    trace = os.path.join(work, "warm_trace.json")
    prof.export_chrome_trace(trace)
    busy_ms, by_name = device_busy(trace)
    n = len(signals)
    log(f"warm: rescue oracle build {oracle_s:.3f} s; streaming_map of {n} "
        f"reads {warm_s:.3f} s = {n / warm_s:.3f} reads/s")
    log(f"warm profile: wall {prof_s * 1000:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / (prof_s * 1000):.4f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, cnt) in top:
        log(f"  device {ms:10.3f} ms {cnt:6d}x  {name[:70]}")


ALIGN_LINE = re.compile(
    r"Read name: (\S+), reference name: (\S+)\n"
    r"DTW distance: ([^,]+), (?:mapping_end_position: (-?\d+)\.|"
    r"feature_mapping_end_position: (-?\d+), "
    r"rough mapping end postion: (-?\d+)\.)")


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
    args = tuple(a.to(dev) for a in args)
    rec = check(records, "sdtw", f"B={B} T={T} Q={Q}", sdtw(*args),
                lambda: sdtw(*args), lambda: sdtw_plain(*args),
                sub="bench_dtw", work=sdtw_work(args[1], args[3], T, Q))
    rec["cell_updates_per_s"] = B * T * Q / (rec["ms"] / 1e3)
    log(f"sdtw bench shape: {rec['cell_updates_per_s']:.6e} cell updates/s")

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
        labels, targets, queries = prep(ref, pore, sig)[:3]
        assert debug_modes.batch_bounds(targets, queries) == [
            (0, len(targets))], "the pairs should fit one batch"
        args = debug_modes.pack_pairs(targets, queries, dev)
        got = sdtw(*args)
        rec = check(records, "sdtw",
                    f"{mode} pairs={len(targets)} T={args[0].shape[1]} "
                    f"Q={args[2].shape[1]}", got, lambda: sdtw(*args),
                    lambda: sdtw_plain(*args), plain_reps=0,
                    sub=None if mode == "dtw-align" else "cwt_align",
                    work=sdtw_work(args[1], args[3], args[0].shape[1],
                                   args[2].shape[1]))
        cells = sum(len(t) * len(q) for t, q in zip(targets, queries))
        rec["cell_updates_per_s"] = cells / (rec["ms"] / 1e3)
        log(f"sdtw {mode}: {cells} cells, "
            f"{rec['cell_updates_per_s']:.6e} cell updates/s")

        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(buf):
            rc = cli.main(["--debug-mode", mode, "-r", ref, "-p", pore,
                           "-s", sig])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[mode] = dict(LAUNCHES)
        assert rc == 0, f"{mode} failed ({rc})"
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
        log(f"{mode} via CLI: {len(lines)} lines in {wall:.3f} s; sdtw "
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


def score_paf(path, reads):
    """(mapped, correct) against the simulation truth (bench.py accuracy)."""
    by_name = {}
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            if int(c[11]) > 60:
                continue
            by_name[c[0]] = (c[4], int(c[7]), int(c[8]))
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
    assert mapped >= 0.99 * n, f"only {mapped}/{n} reads mapped"
    assert correct >= 0.99 * n, f"only {correct}/{n} reads mapped correctly"
    for name in ("peaks", "compress_keep", "sweep", "chain_fused"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the main path"

    profile_warm(mapper, signals, work)
    mapper.close()
    del mapper, signals
    torch.cuda.empty_cache()

    debug_phase(records, by_path, dev, os.path.join(work, "debug"))
    exact_phase(records, by_path, dev, work, reads,
                ["-m", *common, "-x", os.path.join(work, "idx"),
                 "--read-batch", str(EXACT_READ_BATCH)])

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
