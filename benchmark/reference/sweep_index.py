"""The sweep tile store, worked out again from the reference's index: a
frozen copy of the port's ``index/sweep.py:SweepIndex.build`` (PCA basis
from a sample, rotated windows sorted by the span-3 cell grid, tiles of
TILE windows and their packed metadata)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SWEEP_DIMS = 4
SWEEP_SPAN = 3
PAD_COORD = 1.0e30
META_POS_BITS = 25


def bucket_dims(dim: int) -> int:
    return min(SWEEP_DIMS, dim)


@dataclass
class Sweep:
    tiles: np.ndarray
    meta: np.ndarray
    cum: np.ndarray
    rot: np.ndarray
    mu: np.ndarray
    origin: np.ndarray
    radixes: tuple
    span: int
    cell_width: float
    tile: int


def build(idx, radius: float, tile: int = 1024,
          span: int = SWEEP_SPAN) -> Sweep:
    """``idx``: the reference's ``index.Index``."""
    nw = idx.n_windows
    dim = idx.dim
    if dim < 2:
        raise ValueError("sweep layout needs index dim >= 2")
    if dim > 8:
        raise ValueError("sweep layout packs windows into 8 f32 rows")
    bd = bucket_dims(dim)
    w = 2.0 * float(np.sqrt(radius)) / (span - 1)
    if len(idx.ref_lengths) * 2 > (1 << (31 - META_POS_BITS)):
        raise ValueError("too many reference sequences for packed meta")
    if nw and int(idx.win_pos.max(initial=0)) >= (1 << META_POS_BITS):
        raise ValueError(
            "target positions overflow packed meta "
            f"(>= 2^{META_POS_BITS}); shard the index first"
        )
    # windows as [nw, dim] strided view over the flat value array
    Wview = np.lib.stride_tricks.sliding_window_view(
        idx.values, dim
    )[:nw]
    # PCA basis from a SAMPLE in f64 (covariance is 6x6; eigh exact);
    # the full-array rotation then runs in f32 accumulated from dim
    # shifted views — no [nw, dim] f64 materialization (the f64 copy +
    # matmul dominated index-load time at 12 Mb: ~35 s on this host)
    samp = Wview[:: max(1, nw // 300_000)].astype(np.float64)
    mu = samp.mean(axis=0) if len(samp) else np.zeros(dim)
    if len(samp) > dim:
        cov = np.cov((samp - mu).T)
        evals, evecs = np.linalg.eigh(np.atleast_2d(cov))
        order = np.argsort(evals)[::-1]
        rot = evecs[:, order]
    else:
        rot = np.eye(dim)
    rot_f = rot.astype(np.float32)
    vals = idx.values.astype(np.float32, copy=False)
    WR = np.empty((nw, dim), np.float32)               # [nw, dim]
    WR[:] = -(mu @ rot).astype(np.float32)[None, :]
    for d in range(dim):
        WR += vals[d : d + nw, None] * rot_f[d][None, :]
    origin = (
        WR[:, :bd].min(axis=0) if nw else np.zeros(bd, np.float32)
    )
    radixes = tuple(
        int(x) for x in (
            np.ceil(
                ((WR[:, :bd].max(axis=0) - origin) / w)
            ).astype(np.int64) + 2
            if nw else np.full(bd, 2, np.int64)
        )
    )
    keyspace = int(np.prod(radixes))
    if keyspace > (1 << 27):
        raise ValueError(f"sweep cell table too large ({keyspace})")
    coords = np.clip(
        np.floor((WR[:, :bd] - origin) / w).astype(np.int64),
        0, np.asarray(radixes, np.int64)[None, :] - 1,
    )
    key = coords[:, 0].copy() if nw else np.zeros(0, np.int64)
    for d in range(1, bd):
        key = key * radixes[d] + coords[:, d]
    perm = np.argsort(key, kind="stable").astype(np.int32)
    counts = np.bincount(key, minlength=keyspace)
    cum = np.zeros(keyspace + 1, np.int32)
    np.cumsum(counts, out=cum[1:])
    T = max(1, -(-nw // tile))
    meta_flat = (
        (idx.win_group[perm].astype(np.int32) << META_POS_BITS)
        | idx.win_pos[perm].astype(np.int32)
    )
    tiles = np.zeros((T * tile, 8), np.float32)
    tiles[:nw, :dim] = WR[perm]
    tiles[nw:, 0] = PAD_COORD
    meta = np.zeros(T * tile, np.int32)
    meta[:nw] = meta_flat
    # [T, 8, tile//8]: a tile's windows transposed, and their metadata
    tiles_t = np.ascontiguousarray(
        tiles.reshape(T, tile, 8).transpose(0, 2, 1))
    meta_t = meta.reshape(T, 8, tile // 8)
    return Sweep(tiles=tiles_t, meta=meta_t, cum=cum,
                 rot=rot.astype(np.float32), mu=mu.astype(np.float32),
                 origin=origin.astype(np.float32), radixes=radixes,
                 span=span, cell_width=w, tile=tile)
