"""Preparation around the sweep kernel (B3): one round's radius search.

Counterpart of ``sigmap_tpu/mapping/sweep_search.py``: rotate seeds into the
index's PCA basis, sort them (stably) by lo-corner cell key, compute each
seed block's union of tile ranges from the dense cumulative cell table,
merge them into disjoint intervals, put the blocks with the most tiles
first, run the kernel, and return results in the original seed order.
The reference's fixed-size launch chunking (``MAXG``) is not needed on the
GPU: one launch covers every block.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops.sweep_kernel import sweep_search

BIG = 2**31 - 1
SEED_PAD = 2.0e9


# (radixes, device) -> [bd] f32 radix - 1 per bucketed dim: made once, by a
# round's first (eager) run, so that a captured round copies nothing from
# the host
_CELL_HI: dict = {}


def cell_limits(radixes: tuple, device):
    """The largest cell index per bucketed dim, [bd] f32 on ``device``."""
    key = (tuple(radixes), torch.device(device))
    hi = _CELL_HI.get(key)
    if hi is None:
        hi = _CELL_HI[key] = torch.tensor(
            [r - 1 for r in radixes], dtype=torch.float32, device=device)
    return hi


def _cells(v, w: float, radixes: tuple):
    """floor(v / w) clipped to [0, radix-1] per bucketed dim -> i32.

    The clip happens before the integer conversion, so values far outside
    the grid (padding seeds) saturate like the reference's conversion.  The
    divisor is a tensor: CUDA division by a host scalar multiplies by its
    reciprocal, which rounds differently from an f32 division."""
    wt = torch.full_like(v, w)
    c = torch.floor(v / wt)
    return torch.minimum(torch.clamp(c, min=0.0),
                         cell_limits(radixes, v.device)).to(torch.int32)


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


def sweep_round(seeds, cum, tiles, meta, rot, mu, origin, radius: float,
                K: int = 16, TILE: int = 1024, dim: int = 6, block: int = 32,
                radixes: tuple = (), span: int = 3,
                cell_width: float = 0.2828427):
    """Full radius search for one round's seeds [Q0, 8] (raw coords, invalid
    seeds = SEED_PAD), in the original seed order.

    Returns (m_meta [Q0, K] i32, m_d2 [Q0, K] f32, cnt [Q0] i32 exact
    totals, wrote [Q0] i32 slots filled)."""
    Q0 = seeds.shape[0]
    qr_s, blockmeta, perm = longest_first(*prepare_round(
        seeds, cum, tiles.shape[0], rot, mu, origin, radius, TILE, dim,
        block, radixes, span, cell_width,
    ), block)
    m_meta, m_d2, m_cnt = sweep_search(
        qr_s, blockmeta, tiles, meta, radius=radius, K=K, TILE=TILE,
        dim=dim, block=block,
    )
    iperm = torch.empty_like(perm)
    iperm[perm] = torch.arange(perm.shape[0], device=perm.device)
    iperm = iperm[:Q0]
    return m_meta[iperm], m_d2[iperm], m_cnt[iperm, 0], m_cnt[iperm, 1]
