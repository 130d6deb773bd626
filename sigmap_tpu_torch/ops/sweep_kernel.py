"""Kernel B3: the streaming merge-join radius search ("sweep").

CUDA source: ``sigmap_tpu_torch/csrc/sweep.cu``; it replaces
``sigmap_tpu/ops/sweep_kernel.py:_kernel`` (via ``sweep_search``).  The
wrapper runs the plain version on a CPU tensor and launches the kernel on a
CUDA tensor.

Contract (identical for both): seeds [Q, 8] f32 rotated and sorted by cell
key, Q a multiple of ``block``; blockmeta [2*NO+1, Q//block] i32 (rows
0..NO-1 first tile per offset, rows NO..2*NO the exclusive tile cumsum);
tiles [T, 8, TILE] f32; meta [T, 8, TILE//8] i32.  Returns m_meta [Q, K]
i32, m_d2 [Q, K] f32 (empty slots 0) and m_cnt [Q, 2] i32 (exact match
total, slots written).  There is no ``nwave`` knob: the number of drain
waves run unconditionally never changes a seed's slots (an extra wave only
retires candidates that could no longer be inserted).

The kernel takes TILE a multiple of 256, ``block`` a multiple of 4, dim
1..8 and K <= 32 (a seed's slots sit in the lanes of one warp while it is
drained).  The launch option ``overflow`` (one i32 on the device) receives
the number of (seed, tile) drains that overflowed the kernel's sparse
candidate list and took its dense path; the outputs do not depend on it,
and the plain version, which has no candidate list, takes no such option.
"""

from __future__ import annotations

import torch

from .._build import check, count_launch, kernels

INF = 1.0e30


def _tile_of(starts, cums, s: int):
    """Flat step s -> global tile per block (offset decoded via cumsum)."""
    t = starts[:, 0] + s
    for oo in range(1, starts.shape[1]):
        t = torch.where(cums[:, oo] <= s, starts[:, oo] + (s - cums[:, oo]), t)
    return t


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
    seed."""
    dev = seeds.device
    Q = seeds.shape[0]
    G = Q // block
    NO = (blockmeta.shape[0] - 1) // 2
    T = tiles.shape[0]
    radius32 = torch.tensor(radius, dtype=torch.float32, device=dev)
    starts = blockmeta[:NO].t().to(torch.int64)                  # [G, NO]
    cums = blockmeta[NO:].t().to(torch.int64)                    # [G, NO+1]
    total = cums[:, NO]
    sq = seeds.view(G, block, 8)[:, :, :dim]
    tiles_d = tiles[:, :dim, :]
    meta_f = meta.reshape(T, TILE)
    out_d = torch.full((G, block, K), INF, dtype=torch.float32, device=dev)
    out_m = torch.zeros((G, block, K), dtype=torch.int32, device=dev)
    wrote = torch.zeros((G, block), dtype=torch.int64, device=dev)
    cnt = torch.zeros((G, block), dtype=torch.int64, device=dev)
    n_steps = int(total.max().item()) if G else 0
    for s in range(n_steps):
        act = torch.nonzero(total > s).squeeze(1)
        nb = act.numel()
        t = _tile_of(starts[act], cums[act], s)
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


def sweep_search(seeds, blockmeta, tiles, meta, radius: float, K: int,
                 TILE: int, dim: int, block: int, overflow=None):
    """B3 wrapper (see the module docstring for the contract)."""
    dev = seeds.device
    if dev.type == "cpu":
        return sweep_search_plain(seeds, blockmeta, tiles, meta, radius, K,
                                  TILE, dim, block)
    if dev.type != "cuda":
        raise ValueError(f"sweep_search: unsupported device {dev}")
    Q = seeds.shape[0]
    T = tiles.shape[0]
    if Q % block or seeds.shape[1] != 8:
        raise ValueError("sweep_search: seeds must be [Q, 8], Q % block == 0")
    if tiles.shape != (T, 8, TILE) or meta.shape != (T, 8, TILE // 8):
        raise ValueError("sweep_search: tile store shape mismatch")
    if TILE % 256 or not 1 <= dim <= 8 or block % 4 or not 1 <= K <= 32:
        raise ValueError("sweep_search: TILE must be a multiple of 256, "
                         "block of 4, dim in 1..8 and K in 1..32")
    G = Q // block
    NO = (blockmeta.shape[0] - 1) // 2
    if blockmeta.shape != (2 * NO + 1, G):
        raise ValueError("sweep_search: blockmeta shape mismatch")
    if overflow is not None and overflow.shape != (1,):
        raise ValueError("sweep_search: overflow must be [1]")
    for x, dt in ((seeds, torch.float32), (blockmeta, torch.int32),
                  (tiles, torch.float32), (meta, torch.int32),
                  (overflow, torch.int32)):
        if x is None:
            continue
        if x.dtype != dt or not x.is_contiguous() or x.device != dev:
            raise ValueError("sweep_search: inputs must be contiguous "
                             "f32/i32 tensors on one device")
    m_meta = torch.empty((Q, K), dtype=torch.int32, device=dev)
    m_d2 = torch.empty((Q, K), dtype=torch.float32, device=dev)
    m_cnt = torch.empty((Q, 2), dtype=torch.int32, device=dev)
    lib = kernels()
    err = lib.sig_sweep_launch(
        seeds.data_ptr(), blockmeta.data_ptr(), G, NO, tiles.data_ptr(),
        meta.data_ptr(), TILE, float(radius), K, dim, block,
        m_meta.data_ptr(), m_d2.data_ptr(), m_cnt.data_ptr(),
        None if overflow is None else overflow.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "sweep")
    count_launch("sweep")
    return m_meta, m_d2, m_cnt
