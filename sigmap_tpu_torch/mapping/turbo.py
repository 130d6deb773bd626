"""Turbo engine: device-resident streaming mapping rounds.

Counterpart of ``sigmap_tpu/mapping/turbo.py`` (read its docstring for the
algorithm and its documented divergences from the exact path).  Per read
batch: one upload of its pA, the reference's transport quantization on the
device (``quantize``), then event detection for all of the batch's chunks
(``batch_features``: kernels B1 and B2).  Per
lockstep round (``turbo_round``): seed windows, the sweep radius search
(kernel B3), anchors in qpos-major [A, B] layout, fused chaining (kernel
B4), candidacy gates, stop rules and best-so-far state, all on the device;
the host reads one packed [B+2] array per round.  Reads that end unmapped
after a capacity overflow are re-mapped by the host exact engine (rescue).

At OVERLAP_MIN_BATCH reads a batch and more, batch N+1's head (its pA
staged in a pinned host buffer, the upload, the quantization and
``batch_features``) runs on a prepare thread, on a side CUDA stream, while
batch N's rounds run on the caller's stream; the caller's stream waits on
the batch's event before its first round (``TurboMapper.streaming_map``).
Smaller batches are prepared inline, one after another.  The tile store is
built once, on the mapper's device (``SweepIndex.build_cached``), or read
from ``runtime.sweep_cache_dir`` where an earlier build wrote it.

A batch's ``batch_features`` runs its B * NC chunk rows in blocks of at
most ``HEAD_ROWS`` (``head_blocks``), so the head's device memory is one
block's at every read length.  On a GPU each round and each head block is
the replay of a CUDA graph (``mapping/graphs.py``; ``TurboMapper._graphs``),
as the JAX package runs them as jitted programs; a round splits at its
merge hook into ``round_search`` and ``round_finish``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..config import (
    ChainingConfig, EventDetectorConfig, MappingConfig, SigmapConfig,
)
from ..index.build import SignalIndex
from ..index.sweep import META_POS_BITS, SweepIndex
from ..io.paf import ChainsSummary, PAFRecord, streaming_tags
from ..io.signals import ReadSignal
from ..ops.chain_fused import chain_fused, check_fits
from ..signal.events import batch_generate_features
from .spans import Span, new_pass, setup_span, span
from .sweep_search import SEED_PAD, sweep_round

NEG = -1.0e30


@dataclass(frozen=True)
class TurboParams:
    """Shapes of the turbo round (the reference's operating point,
    turbo.py:80-99).  The reference's ``nwave`` is absent: drain waves run
    unconditionally never change a seed's slots, so it does not change
    results."""

    S: int = 256          # seed slots per read per chunk
    K: int = 8            # match slots per seed (reference cap: 5000)
    RING: int = 768       # chaining band / carry size
    TILE: int = 1024      # sweep tile width
    max_events: int = 1024
    max_features: int = 1024
    block: int = 32       # sweep seed block
    # reads that finish unmapped with a capacity overflow (matches past K
    # or seeds past S) are re-mapped through the exact host engine
    rescue: bool = True

    def check(self, device) -> None:
        """Raise ValueError for shapes the kernels of ``device`` cannot
        take.  On a GPU the fused chainer holds a read's ring in shared
        memory beside a window of at least K anchor rows (any S * K is
        taken), so a RING of more than ``max_ring(K)`` slots, some 7,200, is
        refused."""
        if torch.device(device).type == "cuda":
            try:
                check_fits(self.RING + self.S * self.K, self.RING, self.RING,
                           self.K)
            except ValueError as e:
                raise ValueError(f"TurboParams(S={self.S}, K={self.K}, "
                                 f"RING={self.RING}): {e}") from None


@dataclass
class TileStore:
    """The sweep index on the device (index/sweep.py layout)."""

    tiles: torch.Tensor    # [T, 8, TILE] f32 rotated coords
    meta: torch.Tensor     # [T, 8, TILE//8] i32 (group << pos_bits) | tpos
    cum: torch.Tensor      # [prod(radixes)+1] i32 cumulative cell table
    rot: torch.Tensor      # [dim, dim] f32
    mu: torch.Tensor       # [dim] f32
    origin: torch.Tensor   # [bd] f32
    radixes: tuple
    span: int
    cell_width: float
    tile: int
    # on the host, for the rescue's card search (mapping/rescue.py): the
    # cell sort's permutation (tile slot -> index window) and the cell table
    perm: np.ndarray | None = None
    cum_host: np.ndarray | None = None
    pos_bits: int = META_POS_BITS     # meta's split (index/sweep.py)

    def device_bytes(self) -> int:
        """The bytes of its tensors on the device."""
        return sum(t.numel() * t.element_size() for t in (
            self.tiles, self.meta, self.cum, self.rot, self.mu, self.origin))


def _put(a, dt, dev):
    """numpy -> tensor on dev (copies only arrays that are not already
    contiguous, writable and of type dt)."""
    return torch.from_numpy(np.require(a, dt, ["C", "W"])).to(dev)


def tile_store_from_sweep(sw: SweepIndex, device, tiles=None,
                          meta=None) -> TileStore:
    """Host SweepIndex (built with materialize=True) -> device tensors;
    ``tiles`` and ``meta`` where they are on the device already
    (``SweepIndex.build_cached``).  A SweepIndex of the JAX package, which
    the parity tests pass, has no ``pos_bits``: its split is fixed at 25
    (META_POS_BITS)."""
    if tiles is None and sw.tiles is None:
        raise ValueError("SweepIndex was built without materialized tiles")
    dev = torch.device(device)

    def put(a, dt):
        return _put(a, dt, dev)

    return TileStore(
        tiles=put(sw.tiles, np.float32) if tiles is None else tiles,
        meta=put(sw.meta, np.int32) if meta is None else meta,
        cum=put(sw.cum, np.int32), rot=put(sw.rot, np.float32),
        mu=put(sw.mu, np.float32), origin=put(sw.origin, np.float32),
        radixes=tuple(sw.radixes), span=sw.span, cell_width=sw.cell_width,
        tile=sw.tile, perm=sw.perm, cum_host=sw.cum,
        pos_bits=getattr(sw, "pos_bits", META_POS_BITS),
    )


@dataclass
class RoundState:
    """One batch's round state, all on the device."""

    chunk_idx: torch.Tensor   # [B] i32
    done: torch.Tensor        # [B] bool
    stopped: torch.Tensor     # [B] bool (stop rule fired)
    offsets: torch.Tensor     # [B] i32 accumulated feature counts
    carry: tuple              # 8 x [RING, B]: t q g score stt stq n sumd
    rb_f: torch.Tensor        # [4, B] f32 best so far: s1 s2 sumd1 s3
    rb_i: torch.Tensor        # [8, B] i32: g1 tstart tend qstart qend n1
                              #   nc ovf


_CARRY_DTYPES = (np.int32, np.int32, np.int32, np.float32, np.int32,
                 np.int32, np.int32, np.float32)


def round_state_from_numpy(chunk_idx, done, stopped, offsets, carry, rb_f,
                           rb_i, device) -> RoundState:
    """The reference round's state as numpy arrays -> port tensors."""
    dev = torch.device(device)

    def put(a, dt):
        return _put(a, dt, dev)

    return RoundState(
        chunk_idx=put(chunk_idx, np.int32), done=put(done, np.bool_),
        stopped=put(stopped, np.bool_), offsets=put(offsets, np.int32),
        carry=tuple(put(c, dt) for c, dt in zip(carry, _CARRY_DTYPES)),
        rb_f=put(rb_f, np.float32), rb_i=put(rb_i, np.int32),
    )


def init_round_state(B: int, RING: int, device) -> RoundState:
    z = np.zeros((RING, B), np.int32)
    carry = (np.full((RING, B), -(1 << 30), np.int32), z,
             np.full((RING, B), -2, np.int32),
             np.full((RING, B), NEG, np.float32), z, z, z,
             np.zeros((RING, B), np.float32))
    return round_state_from_numpy(
        np.zeros(B, np.int32), np.zeros(B, bool), np.zeros(B, bool),
        np.zeros(B, np.int32), carry, np.full((4, B), NEG, np.float32),
        np.zeros((8, B), np.int32), device,
    )


def build_seeds(feats, counts, offsets, S: int, step: int, dim: int,
                min_feature_length: int):
    """Feature rows -> (seeds [B, S, 8] f32 with SEED_PAD fill, qpos [B, S]
    i32, has_f [B] bool, seed_ovf scalar bool)."""
    B, F = feats.shape
    dev = feats.device
    has_f = counts > min_feature_length
    n_all = torch.where(
        has_f, torch.div(counts - dim, step, rounding_mode="floor"), 0)
    n_seeds = torch.clamp(n_all, 0, S)
    j = torch.arange(S, dtype=torch.int32, device=dev)
    positions = (j + 1) * step
    need = (S + 1) * step + 8
    fp = torch.nn.functional.pad(feats, (0, need - F)) if need > F else feats
    dmask = torch.arange(8, device=dev) < dim
    wins = torch.stack(
        [fp[:, step + c: step + c + step * S: step] for c in range(8)], dim=2
    ) * dmask[None, None, :]
    seed_ok = j[None, :] < n_seeds[:, None]
    pad_row = torch.where(dmask, SEED_PAD, 0.0)
    seeds = torch.where(seed_ok[:, :, None], wins, pad_row[None, None, :])
    seed_ovf = (n_all > S).any()
    qpos = positions[None, :] + offsets[:, None]
    return seeds, qpos, has_f, seed_ovf


def anchors_qpos_major(m_meta, m_d2, wrote, qpos, B: int, S: int, K: int,
                       pos_bits: int = META_POS_BITS):
    """Sweep outputs -> chaining inputs in qpos-major [S*K, B] layout;
    ``pos_bits``: the store's meta split."""
    m_meta = m_meta.reshape(B, S, K)
    kk = torch.arange(K, device=m_meta.device)
    a_valid = kk[None, None, :] < wrote.reshape(B, S)[:, :, None]
    pos_mask = (1 << pos_bits) - 1
    n_t = (m_meta & pos_mask).reshape(B, S * K).t()
    n_g = torch.where(a_valid, m_meta >> pos_bits, -1)
    n_g = n_g.reshape(B, S * K).t()
    n_d = m_d2.reshape(B, S * K).t()
    n_q = qpos[:, :, None].expand(B, S, K).reshape(B, S * K).t()
    return n_t, n_q, n_d, n_g


@dataclass
class RoundSearch:
    """A round up to the sweep's outputs (``round_search``): its reads,
    seeds and match slots.  The slots are those a mapper merges across
    index shards (``merge_matches``) before the round goes on."""

    active: torch.Tensor      # [B] bool
    counts: torch.Tensor      # [B] i32 this round's feature counts
    has_f: torch.Tensor       # [B] bool
    seed_ovf: torch.Tensor    # scalar bool
    qpos: torch.Tensor        # [B, S] i32
    m_meta: torch.Tensor      # [B*S, K] i32
    m_d2: torch.Tensor        # [B*S, K] f32
    cnt: torch.Tensor         # [B*S] i32 exact match totals
    wrote: torch.Tensor       # [B*S] i32 slots filled
    pos_bits: int = META_POS_BITS   # the store's meta split

    def slots(self) -> tuple:
        """The match slots, in merge_matches' argument order."""
        return self.m_meta, self.m_d2, self.cnt, self.wrote

    def with_slots(self, slots) -> "RoundSearch":
        """This round with other match slots (``slots()``'s order)."""
        m_meta, m_d2, cnt, wrote = slots
        return dataclasses.replace(self, m_meta=m_meta, m_d2=m_d2, cnt=cnt,
                                   wrote=wrote)


@dataclass
class RoundAnchors:
    """The first half of a round: seeds searched, anchors laid out for the
    fused chainer (rows 0..RING-1 carried, then qpos-major seed slots)."""

    active: torch.Tensor      # [B] bool
    counts: torch.Tensor      # [B] i32 this round's feature counts
    has_f: torch.Tensor       # [B] bool
    seed_ovf: torch.Tensor    # scalar bool
    cnt: torch.Tensor         # [B*S] i32 exact match totals
    a_t: torch.Tensor         # [A, B] i32
    a_q: torch.Tensor         # [A, B] i32
    a_d: torch.Tensor         # [A, B] f32
    a_g: torch.Tensor         # [A, B] i32


def round_seeds(feats, counts_r, n_full, st: RoundState, p: TurboParams,
                step: int, dim: int, m: MappingConfig):
    """This round's active reads and their seed windows: (active [B],
    counts [B] i32, seeds [B, S, 8], qpos [B, S], has_f [B], seed_ovf)."""
    active = ~st.done & (st.chunk_idx < n_full) & (
        st.chunk_idx < m.max_num_chunks)
    counts = torch.where(active, counts_r, 0).to(torch.int32)
    seeds, qpos, has_f, seed_ovf = build_seeds(
        feats, counts, st.offsets, p.S, step, dim, m.min_feature_length
    )
    return active, counts, seeds, qpos, has_f, seed_ovf


def round_search(store: TileStore, feats, counts_r, n_full, st: RoundState,
                 p: TurboParams, step: int, radius: float, dim: int,
                 m: MappingConfig) -> RoundSearch:
    """Seed windows and the sweep search (B3) of one round: the part of
    turbo_round before the merge hook (turbo.py:159-165)."""
    B = feats.shape[0]
    active, counts, seeds, qpos, has_f, seed_ovf = round_seeds(
        feats, counts_r, n_full, st, p, step, dim, m)
    m_meta, m_d2, cnt, wrote = sweep_round(
        seeds.reshape(B * p.S, 8), store.cum, store.tiles, store.meta,
        store.rot, store.mu, store.origin, radius=radius, K=p.K,
        TILE=p.TILE, dim=dim, block=p.block, radixes=store.radixes,
        span=store.span, cell_width=store.cell_width,
    )
    return RoundSearch(active, counts, has_f, seed_ovf, qpos, m_meta, m_d2,
                       cnt, wrote, store.pos_bits)


def merged(rs: RoundSearch, merge_matches) -> RoundSearch:
    """``rs`` with its match slots passed through ``merge_matches`` (None:
    as they are); see ``round_anchors``."""
    if merge_matches is None:
        return rs
    return rs.with_slots(merge_matches(*rs.slots()))


def anchors_from_search(rs: RoundSearch, st: RoundState,
                        p: TurboParams) -> RoundAnchors:
    """A round's (merged) match slots -> the fused chainer's anchor rows."""
    B = rs.active.shape[0]
    S, K, RING = p.S, p.K, p.RING
    n_t, n_q, n_d, n_g = anchors_qpos_major(rs.m_meta, rs.m_d2, rs.wrote,
                                            rs.qpos, B, S, K, rs.pos_bits)
    c_t, c_q, c_g = st.carry[:3]
    return RoundAnchors(
        active=rs.active, counts=rs.counts, has_f=rs.has_f,
        seed_ovf=rs.seed_ovf, cnt=rs.cnt,
        a_t=torch.cat([c_t, n_t], dim=0).contiguous(),
        a_q=torch.cat([c_q, n_q], dim=0).contiguous(),
        a_d=torch.cat([torch.zeros((RING, B), dtype=torch.float32,
                                   device=n_d.device), n_d],
                      dim=0).contiguous(),
        a_g=torch.cat([torch.where(c_g == -2, -1, c_g), n_g],
                      dim=0).to(torch.int32).contiguous(),
    )


def round_anchors(store: TileStore, feats, counts_r, n_full, st: RoundState,
                  p: TurboParams, step: int, radius: float, dim: int,
                  m: MappingConfig, merge_matches=None) -> RoundAnchors:
    """Seed windows, sweep search (B3) and the anchor layout of one round.

    merge_matches: None, or a callable (m_meta [Q, K], m_d2, cnt, wrote) ->
    the same shapes that merges this shard's match slots with the other
    index shards' (``parallel.turbo_shard``, turbo.py:165,201-202);
    everything after the search, ``cnt`` included, sees its result."""
    rs = round_search(store, feats, counts_r, n_full, st, p, step, radius,
                      dim, m)
    return anchors_from_search(merged(rs, merge_matches), st, p)


def round_finish(rs: RoundSearch, n_full, st: RoundState, p: TurboParams,
                 step: int, radius: float, dim: int,
                 chain_cfg: ChainingConfig, m: MappingConfig):
    """The part of a round after the merge hook (turbo.py:166-293): anchors,
    fused chaining (B4), candidacy gates, stop rules, the new state and the
    host signal.  Returns what ``turbo_round`` returns."""
    B = rs.active.shape[0]
    S, K = p.S, p.K
    i32 = torch.int32
    ra = anchors_from_search(rs, st, p)
    active, counts, has_f, cnt = ra.active, ra.counts, ra.has_f, ra.cnt
    match_ovf = (cnt > K).any()
    c_score, c_stt, c_stq, c_n, c_sumd = st.carry[3:]
    sum_f, sum_i, new_carry = chain_fused(
        ra.a_t, ra.a_q, ra.a_d, ra.a_g, c_score.contiguous(),
        c_stt.contiguous(), c_stq.contiguous(), c_n.contiguous(),
        c_sumd.contiguous(), radius=radius, dim=dim, ring=p.RING,
        cfg=chain_cfg, kb=K,
    )
    s1, s2_raw, s3_raw = sum_f[0], sum_f[1], sum_f[3]
    n1 = sum_i[5]
    # chain candidacy gates of the reference's selection pipeline
    # (spatial_index.cc:230-247,545-546), as in turbo.py
    min_sc = float(np.float32(chain_cfg.min_chaining_score))
    found = active & has_f & (s1 >= min_sc)
    has2 = found & (s2_raw >= min_sc) & (2.0 * s2_raw > s1)
    has3 = has2 & (s3_raw >= min_sc) & (2.0 * s3_raw > s1)
    s2 = torch.where(has2, s2_raw, 0.0)
    s3 = torch.where(has3, s3_raw, 0.0)
    nc = 1 + has2.to(i32) + has3.to(i32)

    # stop rules (sigmap.cc:667-688)
    sm = (s1 + s2 + s3) / nc.to(torch.float32)
    stop = (
        (has2 & (s1 / torch.clamp(s2, min=1e-30) >= m.stop_mapping_ratio))
        | (has2 & (s1 >= m.stop_mapping_mean_ratio * sm))
        | (found & ~has2 & (n1 >= m.stop_mapping_min_num_anchors))
    )

    upd = found & (s1 > st.rb_f[0])
    rb_f = torch.where(upd[None, :], sum_f[:4], st.rb_f)
    rb_i_new = torch.cat([sum_i[:6], nc[None, :], st.rb_i[7:8]], dim=0)
    rb_i = torch.where(upd[None, :], rb_i_new, st.rb_i)
    # row 7 accumulates per-read capacity overflow (rescue routing)
    ovf_read = active & (
        (cnt.reshape(B, S) > K).any(dim=1)
        | (torch.where(has_f, torch.div(counts - dim, step,
                                        rounding_mode="floor"), 0) > S)
    )
    rb_i = torch.cat([rb_i[:7], (rb_i[7] | ovf_read.to(i32))[None, :]], dim=0)

    new_offsets = st.offsets + torch.where(active & has_f, counts, 0)
    exhausted = active & ((st.chunk_idx + 1 >= n_full)
                          | (st.chunk_idx + 1 >= m.max_num_chunks))
    new_done = st.done | ~active | stop | exhausted
    # the reference's stop `break` precedes the loop increment: a stopped
    # read's chunk index stays at the stopping chunk (sigmap.cc:647-689)
    new_chunk_idx = st.chunk_idx + (active & ~stop).to(i32)
    ovf = torch.stack([match_ovf, ra.seed_ovf])
    host_sig = torch.cat([new_done.to(torch.uint8), ovf.to(torch.uint8)])
    new = RoundState(
        chunk_idx=new_chunk_idx.to(i32), done=new_done,
        stopped=st.stopped | stop, offsets=new_offsets.to(i32),
        carry=new_carry, rb_f=rb_f, rb_i=rb_i.to(i32),
    )
    return new, counts, host_sig


def turbo_round(store: TileStore, feats, counts_r, n_full, st: RoundState,
                p: TurboParams, step: int, radius: float, dim: int,
                chain_cfg: ChainingConfig, m: MappingConfig,
                merge_matches=None):
    """One streaming round (turbo.py:159-293) on the device of ``feats``:
    ``round_search``, the merge hook, ``round_finish``.

    feats/counts_r are this round's chunk-feature slice ([B, F] / [B]);
    merge_matches as in ``round_anchors``.
    Returns (new RoundState, counts [B] i32, host_sig [B+2] u8: done flags
    then the match and seed overflow flags)."""
    rs = round_search(store, feats, counts_r, n_full, st, p, step, radius,
                      dim, m)
    return round_finish(merged(rs, merge_matches), n_full, st, p, step,
                        radius, dim, chain_cfg, m)


# Chunk rows a head block.  ``batch_features`` runs a batch's B * NC chunk
# rows in blocks of at most this many, so that the head's intermediates (two
# [R, C] t-statistic rows, the f64 prefix sums, the [R, 2C] emissions) are
# those of one block at every read length, as the JAX package's blocks of
# EVENT_ROWS rows under jax.lax.scan are (turbo.py:349, :398-433).  The
# size is chosen for the H100, not for compile sharing: the smallest whose
# device ms a row at B=2048, NC=30 is within 10% of the largest tried
# (chip_smoke.py phase 12; on an H100 the head's ms a row is flat from 4096
# to 16384 rows, PERF.md §5).
HEAD_ROWS = 4096

# a padding row of a short last block: length 0, identity affine
PAD_ROW = (0, 0.0, 1.0, 0)


def head_blocks(rows: int, block: int) -> list[tuple[int, int]]:
    """The row blocks of a head of ``rows`` chunk rows, as (first row,
    size) pairs.  Every block but the last has ``block`` rows; the last has
    the fewest of block, block // 2, block // 4, ... rows that hold the
    rows left (padded).  So whatever B and NC are, a head's blocks take
    at most log2(block) + 1 sizes."""
    out = []
    for start in range(0, rows, block):
        size = block
        while size // 2 >= rows - start:
            size //= 2
        out.append((start, size))
    return out


def head_inputs(q, qoff, qscale, n_full):
    """A batch's quantized chunks q [B, NC, Cs] i32, qoff/qscale [B] f32
    and n_full [B] i32 as head rows: (q [B*NC, Cs], qoff [B*NC], qscale
    [B*NC], clen [B*NC] i32), each read's affine on its NC rows (an
    expand: no host round trip).  Chunks past a read's n_full get length
    0."""
    B, NC, Cs = q.shape
    rows = B * NC
    chunk_ok = torch.arange(NC, device=q.device)[None, :] < n_full[:, None]
    clen = torch.where(chunk_ok, Cs, 0).to(torch.int32).reshape(rows)
    qoff_r = qoff[:, None].expand(B, NC).reshape(rows)
    qscale_r = qscale[:, None].expand(B, NC).reshape(rows)
    return q.reshape(rows, Cs), qoff_r, qscale_r, clen


def dequantize(q, qoff, qscale):
    """pa [R, Cs] f32 = (q + qoff) * qscale of head rows, which reproduces
    io.signals.dac_to_pa bit for bit for DAC-derived reads."""
    return (q.to(torch.float32) + qoff[:, None]) * qscale[:, None]


def padded_block(part, size: int):
    """Head rows ``part`` (the first n <= size rows of each of
    ``head_inputs``' tensors) padded to ``size`` rows of length 0."""
    n = part[0].shape[0]
    if n == size:
        return tuple(part)
    return tuple(torch.cat([t, torch.full((size - n, *t.shape[1:]), v,
                                          dtype=t.dtype, device=t.device)])
                 for t, v in zip(part, PAD_ROW))


def rows_features(q, qoff, qscale, clen, p: TurboParams,
                  ed_cfg: EventDetectorConfig, compress_delta: float):
    """One head block (the JAX package's ``_features_rows``,
    turbo.py:352-370): head rows -> (feats [R, F] f32, counts [R] i32).  A
    row's features depend on its own samples, affine and length alone."""
    return batch_generate_features(
        dequantize(q, qoff, qscale), clen, cfg=ed_cfg,
        max_events=p.max_events, max_features=p.max_features,
        compress_delta=compress_delta,
    )


def batch_features(q, qoff, qscale, n_full, p: TurboParams,
                   ed_cfg: EventDetectorConfig, compress_delta: float,
                   block: int = HEAD_ROWS, run_block=None):
    """Event-detect and compress all of a batch's chunks (inputs as
    ``head_inputs``) in the row blocks of ``head_blocks(B * NC, block)``,
    each block's features written into the batch's own outputs, so that
    one block's intermediates are live at a time.  ``run_block(size,
    part)`` runs a block of ``size`` rows on its n <= size rows ``part``
    and returns (feats, counts) of at least n rows (default:
    ``rows_features`` on the padded rows; the mapper passes its head
    graphs).  Returns (feats [B, NC, F] f32, counts [B, NC] i32)."""
    B, NC, _ = q.shape
    R = B * NC
    rows = head_inputs(q, qoff, qscale, n_full)
    feats = torch.empty((R, p.max_features), dtype=torch.float32,
                        device=q.device)
    counts = torch.empty(R, dtype=torch.int32, device=q.device)
    for start, size in head_blocks(R, block):
        part = [t[start: start + size] for t in rows]
        n = part[0].shape[0]
        if run_block is None:
            f, c = rows_features(*padded_block(part, size), p, ed_cfg,
                                 compress_delta)
        else:
            f, c = run_block(size, part)
        feats[start: start + n] = f[:n]
        counts[start: start + n] = c[:n]
    return feats.reshape(B, NC, -1), counts.reshape(B, NC)


def stage_batch(batch, B, NC, Cs, max_chunks, pin: bool = False):
    """Host half of the transport quantization (turbo.py:440-473): each
    read's first L = min(length, NC * Cs) pA samples as f32 in a row of pa
    [B, NC * Cs] (pinned if ``pin``; past L a row holds whatever the
    buffer held), and per read L, the DAC affine (scale, off) that the
    reference tries first, and n_full.  Rows past the batch's reads have L
    = 0, scale 1, off 0, n_full 0.  Returns (pa tensor, L, scale, off,
    n_full numpy arrays)."""
    pa = torch.empty((B, NC * Cs), dtype=torch.float32, pin_memory=pin)
    rows = pa.numpy()
    L = np.zeros(B, np.int32)
    scale = np.ones(B, np.float32)
    off = np.zeros(B, np.float32)
    n_full = np.zeros(B, np.int32)
    for i, s in enumerate(batch):
        n_full[i] = min(s.length // Cs, max_chunks)
        L[i] = min(s.length, NC * Cs)
        rows[i, :L[i]] = s.pa[:L[i]]
        scale[i] = (np.float32(s.range / s.digitisation) if s.digitisation
                    else 0)
        off[i] = np.float32(s.offset)
    return pa, L, scale, off, n_full


def quantize(pa, L, scale, off):
    """Device half of the transport quantization: pa [B, N] f32 on the
    device and the host arrays of ``stage_batch`` -> (q [B, N] i32 in
    0..65535, qoff [B] f32, qscale [B] f32) on the device, equal to the
    reference's host quantization (turbo.py:440-473) element for element.
    A read keeps its DAC affine if every rint(pa / scale - off) of its
    first L samples lies in 0..65535 and maps back to its pA exactly;
    otherwise its affine spans its min and max.  Which reads keep it, and
    their min and max, come to the host once, where the fallback affine is
    computed with the reference's own scalar arithmetic.  q is 0 past L."""
    dev = pa.device
    inside = (torch.arange(pa.shape[1], device=dev)[None, :]
              < torch.from_numpy(L).to(dev)[:, None])
    s0 = torch.from_numpy(scale).to(dev)[:, None]
    o0 = torch.from_numpy(off).to(dev)[:, None]
    k = torch.where(inside, torch.round(pa / s0 - o0), 0.0)
    fits = ((k.amin(1) >= 0) & (k.amax(1) <= 65535)
            & torch.where(inside, (k + o0) * s0 == pa, True).all(1))
    lo = torch.where(inside, pa, torch.inf).amin(1)
    hi = torch.where(inside, pa, -torch.inf).amax(1)
    fits, lo, hi = (t.cpu().numpy() for t in (fits, lo, hi))
    qoff, qscale = off.copy(), scale.copy()
    for i in np.flatnonzero((L > 0) & ~((scale > 0) & fits)):
        qscale[i] = np.float32(max(hi[i] - lo[i], 1e-6) / 65000.0)
        qoff[i] = np.float32(lo[i] / qscale[i])
    qoff_d, qscale_d = (torch.from_numpy(a).to(dev) for a in (qoff, qscale))
    k = torch.clamp(torch.round(pa / qscale_d[:, None] - qoff_d[:, None]),
                    0, 65535)
    return torch.where(inside, k, 0.0).to(torch.int32), qoff_d, qscale_d


# The smallest read batch that TurboMapper prepares on its prepare thread
# while the previous batch maps.  The prepare thread and the round loop
# dispatch torch ops under one interpreter lock, and at once they slow
# each other: the rounds beside a preparation take longer by about as much
# as a small batch's head (mostly op dispatch) takes inline.  Measured
# faster at 2048 reads a batch, slower at 128 (PERF.md §6); with the rounds
# and heads replayed as CUDA graphs it still wins every pass only at 2048
# (at 128, 512 and 1024 no better than inline).
OVERLAP_MIN_BATCH = 2048

# Chunk-count buckets of the reference mapper (turbo.py:715).  Kept because
# the fallback quantization's min/max window depends on NC.
_NC_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 30)


def _nc_bucket(nc_raw: int, m: MappingConfig) -> int:
    """The chunk bucket of a batch whose longest read has nc_raw full
    chunks."""
    return next((nc for nc in _NC_BUCKETS
                 if nc >= nc_raw or nc >= m.max_num_chunks), _NC_BUCKETS[-1])


@dataclass
class PreparedBatch:
    """One batch uploaded, quantized and event-detected (``prepare_batch``):
    its device tensors, the host copy of ``n_full``, and on a GPU the event
    recorded after the last of its device work (None on the CPU)."""

    feats: torch.Tensor       # [B, NC, F] f32
    counts: torch.Tensor      # [B, NC] i32
    n_full_d: torch.Tensor    # [B] i32 on the device
    n_full: np.ndarray        # [B] i32 on the host
    event: torch.cuda.Event | None


@contextlib.contextmanager
def _on_stream(device: torch.device, stream):
    """On a GPU: ``device`` as this thread's current device and ``stream``
    (None: the thread's current stream) as its current stream."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


class TurboMapper:
    """Streaming mapper driving turbo_round over device-resident batches of
    ``runtime.read_batch`` reads on an explicit ``device``.  ``oracle`` is
    a rescue oracle of the same index and configuration to share (another
    mapper's ``_get_oracle()``), else it is built at first need."""

    def __init__(self, index: SignalIndex,
                 config: SigmapConfig = SigmapConfig(),
                 params: TurboParams | None = None, *, device, oracle=None):
        self.device = torch.device(device)
        self.index = index
        self.cfg = config
        if index.win_group is None:
            index.derive_window_metadata()
        self.p = params if params is not None else TurboParams()
        self.p.check(self.device)
        with setup_span("setup.tile_store") as sp:
            self.store = self._tile_store()
        self._store_span = sp
        self._oracle = oracle
        self._oracle_lock = threading.Lock()
        self._oracle_kicked = False
        self._rescue_pool = (
            ThreadPoolExecutor(max(1, config.runtime.num_threads),
                               thread_name_prefix="sigmap-turbo-rescue")
            if self.p.rescue else None
        )
        self._rescue_futs: list = []
        self._ovf_warned = False
        self.n_rescued = 0          # reads re-mapped by the exact engine
        self.n_rescued_mapped = 0
        # the rescue's chunk searches: on the card (mapping/rescue.py) and
        # on the host k-d tree
        self.n_rescue_search_device = 0
        self.n_rescue_search_host = 0
        self._card = None
        self._card_lock = threading.Lock()
        self._pass_ids = itertools.count()   # last_pass["pass_id"]
        # the prepare thread (turbo.py:599) and, on a GPU, its side stream
        self._prep_pool = ThreadPoolExecutor(
            1, thread_name_prefix="sigmap-turbo-prepare")
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        if config.runtime.read_batch < OVERLAP_MIN_BATCH:
            self._overlap_batches = False
        if self.device.type != "cuda":
            self._graphs = False
            self._card_rescue = False
        # the graphs met so far (mapping/graphs.py), by everything that
        # fixes their shapes and constants
        self._round_graphs: dict = {}
        self._head_graphs: dict = {}

    def _tile_store(self) -> TileStore:
        """The tile store this mapper searches: the whole index's, built
        on the mapper's device, or read from ``runtime.sweep_cache_dir``
        where an earlier build wrote it (``SweepIndex.build_cached``)."""
        sw, tiles, meta = SweepIndex.build_cached(
            self.index, self.cfg.mapping.search_radius, tile=self.p.TILE,
            cache_dir=self.cfg.runtime.sweep_cache_dir, device=self.device)
        return tile_store_from_sweep(sw, self.device, tiles, meta)

    def build_spans(self) -> list:
        """The set-up spans of what this mapper runs on: its index's
        ``setup.index``, its oracle's ``setup.tree`` (once it is built) and
        its own ``setup.tile_store`` (mapping/spans.py)."""
        found = [getattr(self.index, "build_span", None),
                 getattr(self._oracle, "build_span", None), self._store_span]
        return [sp for sp in found if sp is not None]

    def _get_oracle(self):
        with self._oracle_lock:
            if self._oracle is None:
                from ..oracle import Oracle

                self._oracle = Oracle(self.index, self.cfg)
        return self._oracle

    def _card_search(self):
        """The rescue's card search (``mapping/rescue.py:CardSearch``), made
        at first use, where this mapper searches the whole index's tile
        store (no merge across shards) and ``_card_rescue`` is set; else
        None."""
        if not self._card_rescue or self._merge_matches is not None:
            return None
        with self._card_lock:
            if self._card is None:
                from .rescue import CardSearch

                self._card = CardSearch(self.store, self.index, self.device)
        return self._card

    def _rescue_search(self, card, tree, stamps: dict, read: Span,
                       queries, radius_sq: float, per_cap: int):
        """One chunk's radius search of the rescued read whose span is
        ``read``, as ``KdTree.radius_batch`` answers it: by ``card`` (a
        ``CardSearch`` or None) where it answers, else by ``tree``."""
        with span(stamps, "rescue.search", read.index, read.batch) as ss:
            got = (card(queries, radius_sq, per_cap) if card is not None
                   else None)
            on_card = got is not None
            if not on_card:
                got = tree.radius_batch(queries, radius_sq, per_cap=per_cap)
            ss.numbers.update(device=int(on_card), seeds=len(queries),
                              matches=len(got[0]),
                              past_cap=int((got[2] >= per_cap).sum()))
        with self._card_lock:
            if on_card:
                self.n_rescue_search_device += 1
            else:
                self.n_rescue_search_host += 1
        return got

    def _rescue_one(self, rid: int, s: ReadSignal, turbo_mt: float,
                    stamps: dict, epilogue: Span):
        """Re-map one read with the exact engine, on a rescue thread: span
        rescue.read of the pass ``stamps``, a child of the ``epilogue``
        that submitted it, with the thread's CPU time over it (``cpu_s``).
        Each chunk's radius search runs on the card where it can
        (``_card_search``), else on the k-d tree: span rescue.search, a
        child of rescue.read, with its ``device`` (1 on the card), ``seeds``
        and ``matches``."""
        from .records import streaming_record

        with span(stamps, "rescue.read", epilogue.index,
                  epilogue.batch) as sp:
            cpu0 = time.thread_time()
            oracle = self._get_oracle()
            search = functools.partial(self._rescue_search,
                                       self._card_search(), oracle.tree,
                                       stamps, sp)
            chunk_idx_adj, num_events, chains, _stopped = \
                oracle.streaming_read(s.pa, search)
            sp.numbers["cpu_s"] = time.thread_time() - cpu0
            sp.close()
        return rid, streaming_record(
            self.index, self.cfg, rid, s.read_id, s.length, chunk_idx_adj,
            num_events, chains, turbo_mt + sp.s * 1000,
        )

    def close(self):
        self._prep_pool.shutdown(wait=True)
        if self._rescue_pool is not None:
            self._rescue_pool.shutdown(wait=True)

    # merges each round's match slots across index shards (merge_matches
    # of turbo_round); parallel.turbo_shard sets it, None on one device
    _merge_matches = None

    # cross-batch overlap (turbo.py:645-651): batch N+1 is prepared while
    # batch N maps.  False prepares each batch inline on the caller's
    # stream, for a mapper whose processes must all dispatch their device
    # work in one order; __init__ sets it False below OVERLAP_MIN_BATCH
    _overlap_batches = True

    # rounds and batch heads as replays of CUDA graphs (mapping/graphs.py),
    # the counterpart of the JAX package's jitted turbo_round and
    # batch_features; False runs them op by op.  __init__ sets it False on
    # the CPU, where a test may set it True to run the graphs' static
    # buffers without a capture
    _graphs = True

    # the rescue's chunk searches on the card (_card_search); __init__ sets
    # it False on the CPU, where a test may set it True to run the plain
    # version of the search kernel
    _card_rescue = True

    # chunk rows a head block (batch_features); a test may set a small one
    _head_block = HEAD_ROWS

    def _round_graph(self, B: int, F: int):
        """The round graph of batch shape (B, F), made at its first use."""
        from .graphs import RoundGraph

        m = self.cfg.mapping
        args = (self.store, self.p, m.step_size, m.search_radius,
                self.index.dim, self.cfg.chain, m)
        split = self._merge_matches is not None
        key = (B, F, id(self.store), *args[1:], split)
        g = self._round_graphs.get(key)
        if g is None:
            g = self._round_graphs[key] = RoundGraph(args, B, F, self.device,
                                                     split=split)
        return g

    def _head_graph(self, R: int, Cs: int):
        """The head graph of row blocks of R rows of Cs samples, made at
        its first use.  Block sizes halve (``head_blocks``), so a mapper's
        head graphs hold at most twice one full block's pool."""
        from .graphs import HeadGraph

        args = (self.p, self.cfg.event, self.cfg.mapping.compress_delta)
        key = (R, Cs, *args)
        g = self._head_graphs.get(key)
        if g is None:
            g = self._head_graphs[key] = HeadGraph(R, Cs, *args, self.device)
        return g

    def _run_head_block(self, size: int, part):
        """One row block of a batch's head as a replay of its head graph
        (``batch_features``' ``run_block``)."""
        return self._head_graph(size, part[0].shape[1]).run(*part)

    def graph_stats(self) -> list[dict]:
        """Each graph of this mapper: its captures, replays, capture ms,
        pool MiB and launches a replay (``graphs.RoundGraph.stats``)."""
        return [g.stats() for g in (*self._round_graphs.values(),
                                    *self._head_graphs.values())]

    def streaming_map(self, signals: list[ReadSignal]) -> list[PAFRecord]:
        records: dict[int, PAFRecord] = {}
        B = self.cfg.runtime.read_batch
        batches = [(base, signals[base: base + B])
                   for base in range(0, len(signals), B)]
        # where the pass spent its host time, as spans (mapping/spans.py),
        # and the reads (indices into signals) whose capacity overflowed
        # (row 7 of rb_i) and those the exact engine re-mapped
        self.last_pass = stamps = new_pass(next(self._pass_ids))
        stamps.update(build=self.build_spans(),
                      store_bytes=self.store.device_bytes())
        with span(stamps, "map.pass", None, t0=stamps["start"]):
            if not self._overlap_batches:
                for bi, (base, batch) in enumerate(batches):
                    self._map_batch(batch, base, records, self.prepare_batch(
                        batch, None, stamps, bi))
            elif batches:
                # batch N+1's head runs on the prepare thread, on the side
                # stream, while batch N's rounds run here (turbo.py:663-676)
                pending = self._prep_pool.submit(
                    self.prepare_batch, batches[0][1], self._side, stamps, 0)
                try:
                    for i, (base, batch) in enumerate(batches):
                        fut, pending = pending, None
                        with span(stamps, "head.wait", batch=i):
                            prep = fut.result()
                        if i + 1 < len(batches):
                            pending = self._prep_pool.submit(
                                self.prepare_batch, batches[i + 1][1],
                                self._side, stamps, i + 1)
                        self._map_batch(batch, base, records, prep)
                except BaseException as e:
                    # the next batch's preparation ends before the error
                    # propagates
                    if (pending is not None
                            and pending.exception() is not None):
                        e.add_note("the next batch's preparation failed "
                                   f"too: {pending.exception()!r}")
                    raise
            with span(stamps, "rescue.drain") as drain:
                out = self._drain_rescues(records, len(signals))
            stamps["rescues"] = (drain.t0, drain.t1)
        return out

    def _drain_rescues(self, records: dict, n: int) -> list[PAFRecord]:
        if self._rescue_futs:
            n_remap = 0
            for fut in self._rescue_futs:
                rid, rec = fut.result()
                if rec.is_mapped:
                    n_remap += 1
                records[rid] = rec
                self.last_pass["rescued"].append(rid)
            self.n_rescued += len(self._rescue_futs)
            self.n_rescued_mapped += n_remap
            print(
                f"turbo: {len(self._rescue_futs)} capacity-overflow reads "
                f"re-mapped through the exact engine ({n_remap} mapped)",
                file=sys.stderr,
            )
            self._rescue_futs = []
        return [records[i] for i in range(n) if i in records]

    def upload_batch(self, batch: list[ReadSignal],
                     stamps: dict | None = None, bi: int | None = None):
        """Copy one batch's pA to the device on the current stream (from a
        pinned buffer on a GPU) and quantize it there: (q [B, NC, Cs] i32,
        qoff [B] f32, qscale [B] f32, n_full [B] i32) on the device, and
        n_full on the host.  Spans head.stage and head.quantize of the pass
        ``stamps`` (None: no pass), batch ``bi``."""
        m = self.cfg.mapping
        B = self.cfg.runtime.read_batch
        Cs = m.chunk_size
        with span(stamps, "head.stage", batch=bi):
            NC = _nc_bucket(max(1, max((min(s.length // Cs, m.max_num_chunks)
                                        for s in batch), default=1)), m)
            pa, L, scale, off, n_full = stage_batch(
                batch, B, NC, Cs, m.max_num_chunks,
                pin=self.device.type == "cuda")
        with span(stamps, "head.quantize", batch=bi):
            q, qoff, qscale = quantize(pa.to(self.device, non_blocking=True),
                                       L, scale, off)
            n_full_d = torch.from_numpy(n_full).to(self.device)
        return q.reshape(B, NC, Cs), qoff, qscale, n_full_d, n_full

    def prepare_batch(self, batch: list[ReadSignal], stream=None,
                      stamps: dict | None = None,
                      bi: int | None = None) -> PreparedBatch:
        """Upload, quantize and event-detect one batch (``batch_features``
        in row blocks of ``_head_block``: kernels B1 and B2 once a block,
        turbo.py:698-740), the device work on ``stream`` (None: the
        calling thread's current stream), as the head spans of the pass
        ``stamps`` (None: no pass), batch ``bi``.  On the prepare thread
        with the side stream this is batch N+1's head, which runs while
        batch N's rounds do."""
        m = self.cfg.mapping
        with _on_stream(self.device, stream):
            qd, qoff, qscale, n_full_d, n_full = self.upload_batch(
                batch, stamps, bi)
            with span(stamps, "head.features", batch=bi):
                feats, counts = batch_features(
                    qd, qoff, qscale, n_full_d, self.p, self.cfg.event,
                    m.compress_delta, self._head_block,
                    self._run_head_block if self._graphs else None,
                )
                event = None
                if self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
        return PreparedBatch(feats, counts, n_full_d, n_full, event)

    def _map_batch(self, batch: list[ReadSignal], base: int, records: dict,
                   prep: PreparedBatch):
        """Map one prepared batch: its round loop, then its epilogue (the
        state's download, the records and the rescue submissions), as spans
        of the pass ``last_pass``."""
        m = self.cfg.mapping
        B = self.cfg.runtime.read_batch
        stamps, bi = self.last_pass, base // B
        feats_all, counts_all, n_full_d = prep.feats, prep.counts, \
            prep.n_full_d
        n_full = prep.n_full
        with span(stamps, "round.loop", batch=bi) as loop:
            if prep.event is not None:
                # the rounds wait for the batch's head; the allocator must
                # not hand its tensors to the side stream again before they
                # are read
                main = torch.cuda.current_stream(self.device)
                main.wait_event(prep.event)
                for t in (feats_all, counts_all, n_full_d):
                    t.record_stream(main)
            if self._graphs:
                graph = self._round_graph(B, feats_all.shape[-1])
                graph.start(n_full_d)
            else:
                st = init_round_state(B, self.p.RING, self.device)
            mt = np.zeros(B)
            prev_done = n_full == 0
            done_h = prev_done.copy()
            rounds = 0
            last = None                 # the last host signal's end
            while not done_h.all():
                with span(stamps, "round.launch", loop.index, bi) as launch:
                    if self._graphs:
                        host_sig = graph.run(feats_all[:, rounds],
                                             counts_all[:, rounds],
                                             self._merge_matches)
                    else:
                        st, _counts, host_sig = turbo_round(
                            self.store, feats_all[:, rounds],
                            counts_all[:, rounds], n_full_d, st, self.p,
                            m.step_size, m.search_radius, self.index.dim,
                            self.cfg.chain, m, self._merge_matches,
                        )
                with span(stamps, "round.signal", loop.index, bi,
                          t0=launch.t1) as sig:
                    h = host_sig.cpu().numpy()   # the round's one device read
                    done_h, ovf_h = h[:B].astype(bool), h[B:].astype(bool)
                    if ovf_h.any():
                        if (self._rescue_pool is not None
                                and not self._oracle_kicked):
                            # start building the rescue oracle so it
                            # overlaps rounds
                            self._oracle_kicked = True
                            self._rescue_pool.submit(self._get_oracle)
                        elif (self._rescue_pool is None
                              and not self._ovf_warned):
                            print(
                                "warning: turbo capacity overflow with "
                                f"rescue DISABLED [match={bool(ovf_h[0])} "
                                f"seeds={bool(ovf_h[1])}]; raise "
                                "TurboParams.K / TurboParams.S or anchors "
                                "are dropped",
                                file=sys.stderr,
                            )
                            self._ovf_warned = True
                last = sig.t1
                stamps["round_host"].append((launch.s, last - launch.t0))
                round_ms = (last - launch.t0) * 1000
                act = ~prev_done
                mt[act] += round_ms / max(1, int(act.sum()))
                prev_done = done_h
                rounds += 1
            loop.close(last)
        with span(stamps, "round.epilogue", batch=bi, t0=loop.t1) as epilogue:
            if self._graphs:
                st = graph.state
            rb_f = st.rb_f.cpu().numpy()
            rb_i = st.rb_i.cpu().numpy()
            chunk_idx = st.chunk_idx.cpu().numpy()
            stopped = st.stopped.cpu().numpy()
            offsets = st.offsets.cpu().numpy()
            stamps["overflow"] += [
                base + int(i) for i in np.flatnonzero(rb_i[7, :len(batch)])]
            for i, s in enumerate(batch):
                self._emit(
                    records, base + i, s, rb_f[:, i], rb_i[:, i],
                    int(chunk_idx[i]), bool(stopped[i]), int(offsets[i]),
                    float(mt[i]), int(n_full[i]), epilogue,
                )
        stamps["rounds"].append((loop.t0, epilogue.t1))

    def _emit(self, records, rid, s: ReadSignal, sf, si, chunk_idx,
              stopped_early, num_events, mt_ms, num_chunks,
              epilogue: Span):
        """Output decision + PAF record (sigmap.cc:690-866 semantics;
        turbo.py:870-942, copied: host code); a rescue is submitted as a
        child of the batch's ``epilogue`` span."""
        m = self.cfg.mapping
        if chunk_idx > 0 and not stopped_early:
            # loop-exhaustion adjustment (sigmap.cc:690-693)
            if chunk_idx == num_chunks or chunk_idx == m.max_num_chunks:
                chunk_idx -= 1
        ci = chunk_idx + 1
        sl = s.length
        s1, s2_raw, sumd1, s3_raw = (float(x) for x in sf[:4])
        g1, t_start, t_end, q_start, q_end, n1, nc, ovf = (
            int(x) for x in si
        )
        min_sc = self.cfg.chain.min_chaining_score
        found = s1 >= min_sc
        has2 = found and s2_raw >= min_sc and 2.0 * s2_raw > s1
        has3 = has2 and s3_raw >= min_sc and 2.0 * s3_raw > s1
        s2 = s2_raw if has2 else 0.0
        s3 = s3_raw if has3 else 0.0
        nc = 1 + int(has2) + int(has3) if found else 0
        sm = (s1 + s2 + s3) / nc if nc else 0.0
        scale = 0.0
        if num_events > 0:
            scale = (ci * m.chunk_size / num_events) / (
                m.sample_rate / m.bp_per_sec
            )
        out_ok = found and (
            (has2 and (
                s1 / s2 >= m.output_mapping_ratio
                or s1 >= m.output_mapping_mean_ratio * sm
            ))
            or (nc == 1 and n1 >= m.output_mapping_min_num_anchors)
        )
        summ = None
        if found:
            summ = ChainsSummary(
                num_anchors=n1, num_chains=nc, s1=s1, s2=s2, sm=sm,
                ad=sumd1 / max(1, n1),
                at=(t_end - t_start) / max(1, n1),
                aq=(q_end - q_start) / max(1, n1),
            )
        if out_ok:
            ref_index = g1 // 2
            strand_bit = g1 % 2
            ref_len = self.index.ref_lengths[ref_index]
            tstart = t_start if strand_bit == 0 else ref_len + 1 - t_end
            mapq = 60 if nc == 1 else max(0, min(60, int(40 * (1 - s2 / s1))))
            records[rid] = PAFRecord(
                read_id=rid, read_name=s.read_id, read_length=sl,
                read_start=int(scale * q_start), read_end=int(scale * q_end),
                ref_index=ref_index, fragment_start=int(tstart),
                fragment_length=int(t_end - t_start + 1),
                mapq=mapq, direction=1 if strand_bit == 0 else 0,
                tags=streaming_tags(mt_ms, ci, sl, summ),
            )
        else:
            records[rid] = PAFRecord(
                read_id=rid, read_name=s.read_id, read_length=sl,
                read_start=0, read_end=0, ref_index=0, fragment_start=0,
                fragment_length=0, mapq=61, direction=0,
                tags=streaming_tags(mt_ms, ci, sl, summ),
            )
            if ovf and self._rescue_pool is not None:
                # unmapped and capacity-truncated: the exact engine decides
                self._rescue_futs.append(self._rescue_pool.submit(
                    self._rescue_one, rid, s, mt_ms, self.last_pass,
                    epilogue))
