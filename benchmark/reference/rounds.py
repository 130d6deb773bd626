"""The turbo rounds, plain: seed windows, the sweep radius search, the
anchor layout, the fused chaining, the candidacy gates, the stop rules and
the output decision.

Frozen copies of the port's plain PyTorch versions
(``mapping/sweep_search.py``, the plain B3 of ``ops/sweep_kernel.py``, the
plain B4 of ``ops/chain_fused.py``, and ``mapping/turbo.py``'s round and
``_emit``), importing nothing of the port.  They run on the tile store that
``sweep_index.build`` works out again from the reference's own index,
whose window metadata is 64 bits wide.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from .config import ChainingConfig, MappingConfig
from .records import ChainsSummary, Record, streaming_tags

META_POS_BITS = 32      # meta: (group << 32) | position, int64
NEG = -1.0e30
INF = 1.0e30
BIG = 2**31 - 1
SEED_PAD = 2.0e9


def _cells(v, w: float, radixes: tuple):
    """floor(v / w) clipped to [0, radix-1] per bucketed dim -> i32.

    The clip happens before the integer conversion, so values far outside
    the grid (padding seeds) saturate like the reference's conversion.  The
    divisor is a tensor: CUDA division by a host scalar multiplies by its
    reciprocal, which rounds differently from an f32 division."""
    wt = torch.full_like(v, w)
    c = torch.floor(v / wt)
    hi = torch.tensor([r - 1 for r in radixes], dtype=torch.float32,
                      device=v.device)
    return torch.minimum(torch.clamp(c, min=0.0), hi).to(torch.int32)


def seed_cell_bounds(qr, radius: float, w: float, origin, radixes: tuple,
                     span: int):
    """[Q, bd] rotated seed coords -> per-offset (key_lo, key_hi), each
    [Q, span^(bd-1)] i32 (sweep_search.py:38-71)."""
    bd = len(radixes)
    delta = float(np.float32(np.sqrt(radius)))
    lo = _cells(qr - delta - origin, w, radixes)
    hi = _cells(qr + delta - origin, w, radixes)
    klos, khis = [], []
    for offs in itertools.product(range(span), repeat=bd - 1):
        cs = [lo[:, d] + offs[d] for d in range(bd - 1)]
        ok = cs[0] <= hi[:, 0]
        for d in range(1, bd - 1):
            ok &= cs[d] <= hi[:, d]
        key_lo = cs[0]
        for d in range(1, bd - 1):
            key_lo = key_lo * radixes[d] + cs[d]
        key_lo = key_lo * radixes[bd - 1] + lo[:, bd - 1]
        key_hi = key_lo + (hi[:, bd - 1] - lo[:, bd - 1])
        klos.append(torch.where(ok, key_lo, BIG))
        khis.append(torch.where(ok, key_hi, -1))
    return (torch.stack(klos, dim=1).to(torch.int32),
            torch.stack(khis, dim=1).to(torch.int32))


def rotate_seeds(seeds, rot, mu, dim: int):
    """(seeds[:, :dim] - mu) @ rot, summed explicitly in dim order so every
    device rounds the same way."""
    x = seeds[:, :dim] - mu[None, :]
    cols = []
    for j in range(dim):
        acc = x[:, 0] * rot[0, j]
        for d in range(1, dim):
            acc = acc + x[:, d] * rot[d, j]
        cols.append(acc)
    return torch.stack(cols, dim=1)


def prepare_round(seeds, cum, ntiles: int, rot, mu, origin, radius: float,
                  TILE: int, dim: int, block: int, radixes: tuple, span: int,
                  cell_width: float):
    """Seeds [Q0, 8] -> the kernel's inputs: (rotated seeds sorted by
    lo-corner cell key [Q, 8], blockmeta [2*NO+1, Q//block] i32, perm [Q])
    with Q = Q0 padded up to a multiple of ``block``."""
    dev = seeds.device
    Q0 = seeds.shape[0]
    if Q0 % block:
        pad = block - Q0 % block
        prow = torch.where(torch.arange(8, device=dev) < dim, SEED_PAD, 0.0)
        seeds = torch.cat([seeds, prow[None, :].expand(pad, 8)], dim=0)
    Q = seeds.shape[0]
    bd = len(radixes)
    NO = span ** (bd - 1)
    w = float(np.float32(cell_width))
    delta = float(np.float32(np.sqrt(radius)))
    qr_d = rotate_seeds(seeds, rot, mu, dim)                   # [Q, dim]
    qr8 = torch.cat(
        [qr_d, torch.zeros((Q, 8 - dim), dtype=torch.float32, device=dev)],
        dim=1)
    qb = qr_d[:, :bd]
    qc = _cells(qb - delta - origin, w, radixes)
    skey = qc[:, 0]
    for d in range(1, bd):
        skey = skey * radixes[d] + qc[:, d]
    perm = torch.sort(skey, stable=True).indices
    qr_s = qr8[perm].contiguous()
    klo, khi = seed_cell_bounds(qb[perm], radius, w, origin, radixes, span)
    G = Q // block
    bmin = klo.view(G, block, NO).amin(dim=1).to(torch.int64)
    bmax = khi.view(G, block, NO).amax(dim=1).to(torch.int64)
    CS = cum.shape[0] - 1
    cum64 = cum.to(torch.int64)
    start = cum64[torch.clamp(bmin, 0, CS)]
    end = cum64[torch.clamp(bmax + 1, 0, CS)]
    empty = (bmax < bmin) | (end <= start)
    nt = ntiles
    t0 = torch.where(empty, nt, start // TILE)
    t1 = torch.where(empty, nt, (end + TILE - 1) // TILE)
    # the offsets' unions overlap at tile granularity: merge them into
    # disjoint intervals so every window is evaluated once per block
    order = torch.sort(t0, dim=1, stable=True).indices
    t0s = torch.gather(t0, 1, order)
    t1s = torch.gather(t1, 1, order)
    emax = torch.cummax(t1s, dim=1).values
    prev_end = torch.cat(
        [torch.zeros((G, 1), dtype=torch.int64, device=dev), emax[:, :-1]],
        dim=1)
    m_start = torch.maximum(t0s, prev_end)
    tcnt = torch.clamp(t1s - m_start, min=0)
    m_start = torch.clamp(m_start, 0, max(nt - 1, 0))
    cums = torch.cat(
        [torch.zeros((G, 1), dtype=torch.int64, device=dev),
         torch.cumsum(tcnt, dim=1)], dim=1)
    blockmeta = torch.cat([m_start, cums], dim=1).t().to(torch.int32)
    return qr_s, blockmeta.contiguous(), perm


def longest_first(qr_s, blockmeta, perm, block: int):
    """prepare_round's outputs with the blocks reordered by descending tile
    count (stable).  The kernel starts blocks in launch order, so in a round
    with few live blocks the long ones no longer start last and set the
    tail.  Each block writes only its own outputs and perm moves with it,
    so sweep_round's results do not change."""
    G = blockmeta.shape[1]
    order = torch.sort(blockmeta[-1], descending=True, stable=True).indices
    return (qr_s.view(G, block, 8)[order].reshape(-1, 8),
            blockmeta[:, order].contiguous(),
            perm.view(G, block)[order].reshape(-1))



def step_schedule(blockmeta):
    """Every block's tile steps in the order the plain sweep takes them:
    (block [P], tile [P], bounds) with step s's blocks, ascending, and
    their tiles at [bounds[s], bounds[s+1]).  A block's step s lies in the
    offset o whose steps [cums[o], cums[o+1]) hold it, at tile
    starts[o] + s - cums[o]."""
    NO = (blockmeta.shape[0] - 1) // 2
    starts = blockmeta[:NO].t().to(torch.int64)                  # [G, NO]
    cums = blockmeta[NO:].t().to(torch.int64)                    # [G, NO+1]
    n_o = (cums[:, 1:] - cums[:, :-1]).reshape(-1)
    which = torch.repeat_interleave(
        torch.arange(n_o.numel(), device=blockmeta.device), n_o)
    within = torch.arange(which.numel(), device=blockmeta.device) \
        - torch.repeat_interleave(torch.cumsum(n_o, 0) - n_o, n_o)
    step = cums[:, :NO].reshape(-1)[which] + within
    order = torch.sort(step, stable=True).indices
    bounds = [0] + torch.cumsum(torch.bincount(step), 0).tolist()
    return ((which // NO)[order],
            (starts.reshape(-1)[which] + within)[order], bounds)


def _wave(dbuf, mt, od, om, ow, go, radius32, K: int):
    """One drain wave for seeds [N] (in place on dbuf): the 8 row-group
    minima (lowest lane on ties) inserted in group order."""
    N, TILE = dbuf.shape
    rowsz = TILE // 8
    rows = dbuf.view(N, 8, rowsz)
    mins = rows.amin(dim=2)                                        # [N, 8]
    col = torch.arange(rowsz, device=dbuf.device)
    pcol = torch.where(rows == mins[:, :, None], col, rowsz).amin(dim=2)
    mval = torch.gather(mt.view(N, 8, rowsz), 2, pcol[:, :, None])[:, :, 0]
    has = (mins < radius32) & go[:, None]
    kcol = torch.arange(K, device=dbuf.device)[None, :]
    n_put = torch.zeros_like(ow)
    for r in range(8):
        worst = od.amax(dim=1)
        wi = torch.where(od == worst[:, None], kcol, K).amin(dim=1)
        notfull = (ow + n_put) < K
        slot = torch.where(notfull, ow + n_put, wi)
        put = has[:, r] & (notfull | (mins[:, r] < worst))
        hit = (kcol == slot[:, None]) & put[:, None]
        om = torch.where(hit, mval[:, r, None], om)
        od = torch.where(hit, mins[:, r, None], od)
        n_put = n_put + (put & notfull).to(n_put.dtype)
    rows.scatter_(2, pcol[:, :, None],
                  torch.where(has, INF, torch.gather(rows, 2, pcol[:, :, None])
                              [:, :, 0])[:, :, None])
    return od, om, ow + n_put


def _tau(od, ow, radius32, K: int):
    return torch.where(ow >= K, torch.minimum(od.amax(dim=1), radius32),
                       radius32)


def sweep_search_plain(seeds, blockmeta, tiles, meta, radius: float, K: int,
                       TILE: int, dim: int, block: int):
    """Plain version of B3: a loop over each block's tile steps, vectorised
    over the blocks that have that step, with the drain run literally per
    seed.  The steps' blocks and tiles are laid out once
    (``step_schedule``)."""
    dev = seeds.device
    Q = seeds.shape[0]
    G = Q // block
    T = tiles.shape[0]
    radius32 = torch.tensor(radius, dtype=torch.float32, device=dev)
    blocks, tiles_at, bounds = step_schedule(blockmeta)
    sq = seeds.view(G, block, 8)[:, :, :dim]
    tiles_d = tiles[:, :dim, :]
    meta_f = meta.reshape(T, TILE)
    out_d = torch.full((G, block, K), INF, dtype=torch.float32, device=dev)
    out_m = torch.zeros((G, block, K), dtype=torch.int64, device=dev)
    wrote = torch.zeros((G, block), dtype=torch.int64, device=dev)
    cnt = torch.zeros((G, block), dtype=torch.int64, device=dev)
    for s in range(len(bounds) - 1):
        act = blocks[bounds[s]: bounds[s + 1]]
        t = tiles_at[bounds[s]: bounds[s + 1]]
        nb = act.numel()
        wt = tiles_d[t]                                # [nb, dim, TILE]
        q = sq[act]                                    # [nb, block, dim]
        acc = torch.zeros((nb, block, TILE), dtype=torch.float32, device=dev)
        for d in range(dim):
            diff = wt[:, d, None, :] - q[:, :, d, None]
            acc = acc + diff * diff
        match = acc < radius32
        cnt[act] += match.sum(dim=2)
        # the drain touches only seeds with a candidate below their tau
        seed = act[:, None] * block + torch.arange(block, device=dev)
        seed = seed.reshape(-1)                                  # [nb*block]
        od = out_d.view(-1, K)[seed]
        ow = wrote.view(-1)[seed]
        acc = acc.view(-1, TILE)
        tau = _tau(od, ow, radius32, K)
        cand = match.view(-1, TILE) & (acc < tau[:, None])
        sel = torch.nonzero(cand.any(dim=1)).squeeze(1)
        if sel.numel() == 0:
            continue
        dbuf = torch.where(cand[sel], acc[sel], INF)
        mt = meta_f[t[sel // block]]
        ids = seed[sel]
        od, om, ow = od[sel], out_m.view(-1, K)[ids], ow[sel]
        go = torch.ones(sel.numel(), dtype=torch.bool, device=dev)
        while bool(go.any()):
            od, om, ow = _wave(dbuf, mt, od, om, ow, go, radius32, K)
            go = dbuf.amin(dim=1) < _tau(od, ow, radius32, K)
        out_d.view(-1, K)[ids] = od
        out_m.view(-1, K)[ids] = om
        wrote.view(-1)[ids] = ow
    kcol = torch.arange(K, device=dev)
    out_d = torch.where(kcol < wrote[:, :, None], out_d, 0.0)
    m_cnt = torch.stack([cnt, wrote], dim=2).to(torch.int32)
    return out_m.view(Q, K), out_d.view(Q, K), m_cnt.view(Q, 2)



def sweep_round(seeds, cum, tiles, meta, rot, mu, origin, radius: float,
                K: int = 16, TILE: int = 1024, dim: int = 6, block: int = 32,
                radixes: tuple = (), span: int = 3,
                cell_width: float = 0.2828427):
    """Full radius search for one round's seeds [Q0, 8] (raw coords, invalid
    seeds = SEED_PAD), in the original seed order.

    Returns (m_meta [Q0, K] i64, m_d2 [Q0, K] f32, cnt [Q0] i32 exact
    totals, wrote [Q0] i32 slots filled)."""
    Q0 = seeds.shape[0]
    qr_s, blockmeta, perm = longest_first(*prepare_round(
        seeds, cum, tiles.shape[0], rot, mu, origin, radius, TILE, dim,
        block, radixes, span, cell_width,
    ), block)
    m_meta, m_d2, m_cnt = sweep_search_plain(
        qr_s, blockmeta, tiles, meta, radius=radius, K=K, TILE=TILE,
        dim=dim, block=block,
    )
    iperm = torch.empty_like(perm)
    iperm[perm] = torch.arange(perm.shape[0], device=perm.device)
    iperm = iperm[:Q0]
    return m_meta[iperm], m_d2[iperm], m_cnt[iperm, 0], m_cnt[iperm, 1]


def _push(ring, cur, vals, v, RING: int):
    """Push the valid rows of a block into the ring in row order (a later
    push overwrites an earlier one that lands on the same slot)."""
    vi = v.to(torch.int64)
    rank = torch.cumsum(vi, dim=0) - vi                       # [k, B]
    nval = vi.sum(dim=0)
    keep = v & (rank >= (nval - RING)[None, :])
    slot = (cur[None, :] + rank) % RING
    bcol = torch.arange(v.shape[1], device=v.device)[None, :].expand_as(v)
    si, bi = slot[keep], bcol[keep]
    for r, x in zip(ring, vals):
        r[si, bi] = x[keep]
    return cur + nval


def _best(best, vals):
    """Strict '>' online argmax over a block's rows: the first row with the
    block maximum wins if it beats the running best."""
    s = vals[0]
    k = s.shape[0]
    m = s.amax(dim=0)
    rio = torch.arange(k, device=s.device)[:, None]
    first = torch.where(s == m[None, :], rio, k).amin(dim=0)
    take = m > best[0]
    return tuple(torch.where(take, torch.gather(x, 0, first[None, :])[0], b)
                 for x, b in zip(vals, best))


def chain_fused_plain(a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n,
                      c_sumd, radius: float, dim: int = 6, ring: int = 64,
                      cfg: ChainingConfig = ChainingConfig(), kb: int = 1):
    """Plain version of B4: a loop over KB-row blocks, vectorised over
    reads and ring slots."""
    A, B = a_t.shape
    CARRY = c_score.shape[0]
    RING = ring
    dev = a_t.device
    f32, i32 = torch.float32, torch.int32

    def full(v, dt):
        return torch.full((RING, B), v, dtype=dt, device=dev)

    # ring fields: score, t, q, g, start_t, start_q, n, sumd
    rg = [full(NEG, f32), full(-(1 << 30), i32), full(0, i32), full(-2, i32),
          full(0, i32), full(0, i32), full(0, i32), full(0.0, f32)]
    cur = torch.zeros(B, dtype=torch.int64, device=dev)

    def row1(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    # best: s1, g1, t_end, q_end, start_t, start_q, n, sumd
    best = (row1(NEG, f32), row1(-1, i32), row1(0, i32), row1(0, i32),
            row1(0, i32), row1(0, i32), row1(0, i32), row1(0.0, f32))
    scores = torch.empty((A, B), dtype=f32, device=dev)
    stt_s = torch.empty((A, B), dtype=i32, device=dev)

    # ---- carried rows ----------------------------------------------------
    t, q, g = a_t[:CARRY], a_q[:CARRY], a_g[:CARRY]
    v = g >= 0
    s = torch.where(v, c_score, NEG)
    scores[:CARRY] = s
    stt_s[:CARRY] = c_stt
    vals = (s, g, t, q, c_stt, c_stq, c_n, c_sumd)
    best = _best(best, vals)
    cur = _push(rg, cur, (s, t, q, g, c_stt, c_stq, c_n, c_sumd), v, RING)

    # ---- DP blocks -------------------------------------------------------
    kio = torch.arange(RING, device=dev)[None, :, None]
    # divide by a tensor: CUDA division by a host scalar multiplies by its
    # reciprocal, which rounds differently from the kernel's f32 division
    rad = torch.full((kb, B), radius, dtype=f32, device=dev)
    for blk in range((A - CARRY) // kb):
        i0 = CARRY + blk * kb
        t, q = a_t[i0:i0 + kb], a_q[i0:i0 + kb]
        d, g = a_d[i0:i0 + kb], a_g[i0:i0 + kb]
        v = g >= 0
        coef = 1.0 - (0.2 * d) / rad
        init = coef * dim
        r_s, r_t, r_q, r_g, r_stt, r_stq, r_n, r_sd = rg
        tdiff = t[:, None, :] - r_t[None]                     # [kb, RING, B]
        qdiff = q[:, None, :] - r_q[None]
        ok = ((r_g[None] == g[:, None, :]) & (tdiff > 0) & (qdiff > 0)
              & (r_t[None] + cfg.max_target_gap_length >= t[:, None, :]))
        gap = torch.abs(tdiff - qdiff)
        gs = torch.where(tdiff > 0, qdiff.to(f32) / tdiff.to(f32), 1.0)
        ok &= ((gap < cfg.max_gap_length) & (gs < cfg.max_gap_scale)
               & (gs > cfg.min_gap_scale))
        md = torch.clamp(torch.minimum(tdiff, qdiff), max=dim).to(f32) \
            * coef[:, None, :]
        cand = torch.where(ok, r_s[None] + md, NEG)
        bestc = cand.amax(dim=1)                                # [kb, B]
        bi = torch.where(cand == bestc[:, None, :], kio, RING).amin(dim=1)
        chained = v & (bestc > init)
        s = torch.where(v, torch.where(chained, bestc, init), NEG)
        stt = torch.where(chained, torch.gather(r_stt, 0, bi), t)
        stq = torch.where(chained, torch.gather(r_stq, 0, bi), q)
        n = torch.where(chained, torch.gather(r_n, 0, bi) + 1, 1)
        sumd = torch.where(chained, torch.gather(r_sd, 0, bi) + d, d)
        scores[i0:i0 + kb] = s
        stt_s[i0:i0 + kb] = stt
        best = _best(best, (s, g, t, q, stt, stq, n, sumd))
        cur = _push(rg, cur, (s, t, q, g, stt, stq, n, sumd), v, RING)

    s1, g1, te1, qe1, stt1, stq1, n1, sumd1 = best

    # ---- chain 2 and chain 3 ---------------------------------------------
    def overlaps(gg, st, te):
        return (((a_g >> 1) == (gg >> 1)[None, :])
                & (torch.maximum(stt_s, st[None, :])
                   <= torch.minimum(a_t, te[None, :])))

    excl1 = overlaps(g1, stt1, te1)
    s2 = torch.where(excl1, NEG, scores).amax(dim=0)
    hit = ~excl1 & (scores == s2[None, :]) & (scores > NEG * 0.5)
    rio = torch.arange(A, device=dev)[:, None]
    first = torch.where(hit, rio, A).amin(dim=0)
    found2 = first < A
    fi = torch.clamp(first, max=A - 1)[None, :]
    g2 = torch.where(found2, torch.gather(a_g, 0, fi)[0], -1)
    stt2 = torch.where(found2, torch.gather(stt_s, 0, fi)[0], 0)
    te2 = torch.where(found2, torch.gather(a_t, 0, fi)[0], 0)
    excl2 = found2[None, :] & overlaps(g2, stt2, te2)
    s3 = torch.where(excl1 | excl2, NEG, scores).amax(dim=0)

    zf = torch.zeros(B, dtype=f32, device=dev)
    zi = torch.zeros(B, dtype=i32, device=dev)
    sum_f = torch.stack([s1, s2, sumd1, s3, zf, zf, zf, zf])
    sum_i = torch.stack([g1, stt1, te1, stq1, qe1, n1, zi, zi])
    r_s, r_t, r_q, r_g, r_stt, r_stq, r_n, r_sd = rg
    return sum_f, sum_i, (r_t, r_q, r_g, r_s, r_stt, r_stq, r_n, r_sd)


@dataclass(frozen=True)
class TurboParams:
    """The turbo round's shapes (the configuration's ``turbo_params``)."""

    S: int = 256
    K: int = 8
    RING: int = 768
    TILE: int = 1024
    max_events: int = 1024
    max_features: int = 1024
    block: int = 32
    rescue: bool = True


@dataclass
class TileStore:
    """The sweep index on the device (index/sweep.py layout)."""

    tiles: torch.Tensor    # [T, 8, TILE] f32 rotated coords
    meta: torch.Tensor     # [T, 8, TILE//8] i64 (group << 32) | tpos
    cum: torch.Tensor      # [prod(radixes)+1] i32 cumulative cell table
    rot: torch.Tensor      # [dim, dim] f32
    mu: torch.Tensor       # [dim] f32
    origin: torch.Tensor   # [bd] f32
    radixes: tuple
    span: int
    cell_width: float
    tile: int


def _put(a, dt, dev):
    """numpy -> tensor on dev (copies only arrays that are not already
    contiguous, writable and of type dt)."""
    return torch.from_numpy(np.require(a, dt, ["C", "W"])).to(dev)


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


def anchors_qpos_major(m_meta, m_d2, wrote, qpos, B: int, S: int, K: int):
    """Sweep outputs -> chaining inputs in qpos-major [S*K, B] layout."""
    m_meta = m_meta.reshape(B, S, K)
    kk = torch.arange(K, device=m_meta.device)
    a_valid = kk[None, None, :] < wrote.reshape(B, S)[:, :, None]
    pos_mask = (1 << META_POS_BITS) - 1
    n_t = (m_meta & pos_mask).to(torch.int32).reshape(B, S * K).t()
    n_g = torch.where(a_valid, (m_meta >> META_POS_BITS).to(torch.int32), -1)
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
    m_meta: torch.Tensor      # [B*S, K] i64
    m_d2: torch.Tensor        # [B*S, K] f32
    cnt: torch.Tensor         # [B*S] i32 exact match totals
    wrote: torch.Tensor       # [B*S] i32 slots filled


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
                       cnt, wrote)


def anchors_from_search(rs: RoundSearch, st: RoundState,
                        p: TurboParams) -> RoundAnchors:
    """A round's (merged) match slots -> the fused chainer's anchor rows."""
    B = rs.active.shape[0]
    S, K, RING = p.S, p.K, p.RING
    n_t, n_q, n_d, n_g = anchors_qpos_major(rs.m_meta, rs.m_d2, rs.wrote,
                                            rs.qpos, B, S, K)
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
    sum_f, sum_i, new_carry = chain_fused_plain(
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
                chain_cfg, m):
    """One streaming round: ``round_search`` then ``round_finish``.
    Returns (new RoundState, counts [B] i32, host_sig [B+2] u8)."""
    rs = round_search(store, feats, counts_r, n_full, st, p, step, radius,
                      dim, m)
    return round_finish(rs, n_full, st, p, step, radius, dim, chain_cfg, m)


# ---- output decision ----------------------------------------------------

def emit(cfg, ref_lengths, name: str, sl: int, sf, si, chunk_idx: int,
         stopped_early: bool, num_events: int, num_chunks: int):
    """Output decision and record of one read from its best-so-far state
    (turbo.py:_emit, sigmap.cc:690-866).  Returns (record, whether the
    read ends unmapped after a capacity overflow: the rescue's case)."""
    m = cfg.mapping
    if chunk_idx > 0 and not stopped_early:
        # loop-exhaustion adjustment (sigmap.cc:690-693)
        if chunk_idx == num_chunks or chunk_idx == m.max_num_chunks:
            chunk_idx -= 1
    ci = chunk_idx + 1
    s1, s2_raw, sumd1, s3_raw = (float(x) for x in sf[:4])
    g1, t_start, t_end, q_start, q_end, n1, nc, ovf = (int(x) for x in si)
    min_sc = cfg.chain.min_chaining_score
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
            m.sample_rate / m.bp_per_sec)
    out_ok = found and (
        (has2 and (s1 / s2 >= m.output_mapping_ratio
                   or s1 >= m.output_mapping_mean_ratio * sm))
        or (nc == 1 and n1 >= m.output_mapping_min_num_anchors))
    summ = None
    if found:
        summ = ChainsSummary(
            num_anchors=n1, num_chains=nc, s1=s1, s2=s2, sm=sm,
            ad=sumd1 / max(1, n1), at=(t_end - t_start) / max(1, n1),
            aq=(q_end - q_start) / max(1, n1))
    if out_ok:
        ref_index = g1 // 2
        strand_bit = g1 % 2
        tstart = (t_start if strand_bit == 0
                  else ref_lengths[ref_index] + 1 - t_end)
        mapq = 60 if nc == 1 else max(0, min(60, int(40 * (1 - s2 / s1))))
        return Record(name, sl, int(scale * q_start), int(scale * q_end),
                      ref_index, int(tstart), int(t_end - t_start + 1), mapq,
                      1 if strand_bit == 0 else 0,
                      streaming_tags(ci, sl, summ)), False
    return (Record(name, sl, 0, 0, 0, 0, 0, 61, 0,
                   streaming_tags(ci, sl, summ)), bool(ovf))
