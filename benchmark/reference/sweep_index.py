"""The sweep tile store, worked out again from the reference's index in
plain torch on its device: the port's ``index/sweep.py:SweepIndex.build``
(PCA basis from a sample, rotated windows sorted by the span-3 cell grid,
tiles of TILE windows and their packed metadata).

Every array equals the numpy builder's that it replaced
(``benchmark/tests/numpy_oracle.py``) bit for bit, as ``index`` says; the
PCA basis comes from the same sample in float64 on the host.  The
metadata is packed into 64 bits, ``(group << 32) | position``, ordered as
the port's 32-bit ``(group << 25) | position`` wherever that fits, so the
reference takes any number of sequences and positions.
"""

from __future__ import annotations

import numpy as np
import torch

from .rounds import META_POS_BITS, TileStore

SWEEP_DIMS = 4
SWEEP_SPAN = 3
PAD_COORD = 1.0e30


def bucket_dims(dim: int) -> int:
    return min(SWEEP_DIMS, dim)


def pca_basis(values, nw: int, dim: int):
    """(mu, rot) in float64 from every (nw // 300,000)-th window."""
    step = max(1, nw // 300_000)
    first = torch.arange(0, nw, step, device=values.device)
    samp = torch.stack([values[first + d] for d in range(dim)], dim=1)
    samp = samp.cpu().numpy().astype(np.float64)
    mu = samp.mean(axis=0) if len(samp) else np.zeros(dim)
    if len(samp) > dim:
        cov = np.cov((samp - mu).T)
        evals, evecs = np.linalg.eigh(np.atleast_2d(cov))
        rot = evecs[:, np.argsort(evals)[::-1]]
    else:
        rot = np.eye(dim)
    return mu, rot


def build(idx, radius: float, tile: int = 1024,
          span: int = SWEEP_SPAN) -> TileStore:
    """``idx``: the reference's ``index.Index``; the store lies on its
    device."""
    nw = idx.n_windows
    dim = idx.dim
    dev = idx.values.device
    if dim < 2:
        raise ValueError("sweep layout needs index dim >= 2")
    if dim > 8:
        raise ValueError("sweep layout packs windows into 8 f32 rows")
    bd = bucket_dims(dim)
    w = 2.0 * float(np.sqrt(radius)) / (span - 1)
    mu, rot = pca_basis(idx.values, nw, dim)
    rot_f = torch.from_numpy(rot.astype(np.float32)).to(dev)
    base = -(mu @ rot).astype(np.float32)
    vals = idx.values
    # the rotated windows a column each, every term a multiply and an add
    # of its own in dim order
    cols = []
    for j in range(dim):
        c = torch.full((nw,), float(base[j]), dtype=torch.float32,
                       device=dev)
        for d in range(dim):
            c = c + vals[d: d + nw] * rot_f[d, j]
        cols.append(c)
    if nw:
        origin = np.array([float(c.min()) for c in cols[:bd]], np.float32)
        top = np.array([float(c.max()) for c in cols[:bd]], np.float32)
        radixes = tuple(int(x) for x in np.ceil(
            (top - origin) / w).astype(np.int64) + 2)
    else:
        origin = np.zeros(bd, np.float32)
        radixes = (2,) * bd
    keyspace = int(np.prod(radixes))
    if keyspace > (1 << 27):
        raise ValueError(f"sweep cell table too large ({keyspace})")
    wt = torch.tensor(w, dtype=torch.float32, device=dev)
    key = torch.zeros(nw, dtype=torch.int64, device=dev)
    for d in range(bd):
        o = torch.tensor(origin[d], dtype=torch.float32, device=dev)
        coord = torch.clamp(torch.floor((cols[d] - o) / wt).to(torch.int64),
                            0, radixes[d] - 1)
        key = key * radixes[d] + coord
    perm = torch.sort(key, stable=True).indices
    cum = torch.zeros(keyspace + 1, dtype=torch.int32, device=dev)
    cum[1:] = torch.cumsum(torch.bincount(key, minlength=keyspace), 0)
    del key
    T = max(1, -(-nw // tile))
    # [T, 8, tile]: a tile's windows transposed, and their metadata
    tiles = torch.zeros((T, 8, tile), dtype=torch.float32, device=dev)
    for j in range(dim):
        col = torch.zeros(T * tile, dtype=torch.float32, device=dev)
        col[:nw] = cols[j][perm]
        if j == 0:
            col[nw:] = PAD_COORD
        tiles[:, j, :] = col.view(T, tile)
        cols[j] = None
    meta = torch.zeros(T * tile, dtype=torch.int64, device=dev)
    meta[:nw] = ((idx.win_group[perm].to(torch.int64) << META_POS_BITS)
                 | idx.win_pos[perm].to(torch.int64))
    return TileStore(
        tiles=tiles, meta=meta.view(T, 8, tile // 8), cum=cum, rot=rot_f,
        mu=torch.from_numpy(mu.astype(np.float32)).to(dev),
        origin=torch.from_numpy(origin).to(dev), radixes=radixes,
        span=span, cell_width=w, tile=tile)
