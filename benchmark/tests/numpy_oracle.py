"""The reference's index and tile store builders as they were written in
numpy, frozen: the oracle that ``benchmark/reference/index.py`` and
``sweep_index.py`` (plain torch, on the reference's device) are held to bit
for bit.

``build`` is the signal index: the semantics of the port's
``index/build.py:build_index`` with its native core (``csrc/core.cc``:
``sig_kmer_count`` / ``sig_kmer_mask`` masking with a float compare,
``sig_dedup_stream``): canonical k-mer masking of high-frequency windows,
the z-scored expected signal of both strands, consecutive-point dedup
across streams (positive strands of every sequence, then negative), the
windows' metadata, and the cell grid of ``_finalize_index``.

``build_sweep`` is the sweep tile store, a frozen copy of the port's
``index/sweep.py:SweepIndex.build`` (PCA basis from a sample, rotated
windows sorted by the span-3 cell grid, tiles of TILE windows and their
metadata packed in 32 bits, ``(group << 25) | position``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark import synthgen

CELL_OFFSET = 17
CELL_RADIX = 35


@dataclass
class Index:
    dim: int
    values: np.ndarray        # f32 [N] deduped point values
    win_group: np.ndarray     # i32 [Nw] sequence * 2 + strand
    win_pos: np.ndarray       # i32 [Nw] position on the strand's signal
    ref_lengths: list
    cell_width: float
    bucket_dims: int
    cell_keys: np.ndarray     # i64 sorted occupied cell keys
    cell_starts: np.ndarray   # [K + 1] offsets into ``perm``
    perm: np.ndarray          # i32 [Nw] windows sorted by cell key

    @property
    def n_windows(self) -> int:
        return max(0, len(self.values) - self.dim + 1)


def kmer_masks(seqs, k: int, frequency: float):
    """Masks of windows whose canonical k-mer is frequent: a float compare
    of count / k-mers against ``frequency`` (core.cc:sig_kmer_mask); the
    histogram counts the positive strands.  Every base is unambiguous."""
    size = 1 << (2 * k)
    hist = np.zeros(size, np.int64)
    canon = []
    for codes, neg in seqs:
        pair = []
        for c in (codes, neg):
            fwd = synthgen.kmer_codes(c, k)
            rc = synthgen.kmer_codes(synthgen.revcomp(c), k)[::-1]
            pair.append(np.minimum(fwd, rc))
        hist += np.bincount(pair[0], minlength=size)
        canon.append(pair)
    num = np.float32(sum(len(p[0]) for p in canon))
    frac = hist.astype(np.float32) / num
    freq = np.float32(frequency)
    return [[frac[c] > freq for c in pair] for pair in canon]


def dedup(vals, masked, delta: float, prev):
    """core.cc:sig_dedup_stream: keep an unmasked window if it is the
    stream's first position, or there is no kept value yet, or it differs
    from the last kept value by more than ``delta`` (f32).  Runs of drops
    are walked one by one; elsewhere each window follows its kept
    neighbour.  Returns (kept indices, last kept value or None)."""
    idx = np.flatnonzero(~masked)
    u = vals[idx].astype(np.float32)
    d = np.float32(delta)
    keep = np.ones(len(u), bool)
    if len(u) == 0:
        return idx, prev
    # j is dropped only if |u[j] - last| <= delta; with u[j-1] kept, last
    # is u[j-1], so a run of drops can only start where neighbours are close
    close = np.flatnonzero(np.abs(u[1:] - u[:-1]) <= d) + 1
    starts = list(close)
    if idx[0] != 0 and prev is not None and abs(u[0] - np.float32(prev)) <= d:
        starts.insert(0, 0)
    done_to = -1
    for j in starts:
        if j <= done_to:
            continue
        last = u[j - 1] if j > 0 else np.float32(prev)
        k = j
        while k < len(u) and idx[k] != 0 and abs(u[k] - last) <= d:
            keep[k] = False
            k += 1
        done_to = k
    kept = idx[keep]
    return kept, float(vals[kept[-1]]) if len(kept) else prev


def zscore_f64(x):
    x64 = x.astype(np.float64)
    mean = x64.mean()
    sd = np.sqrt(((x64 - mean) ** 2).sum() / (len(x64) - 1))
    return ((x64 - mean) / sd).astype(np.float32)


def build(genome, pore, cfg, search_radius: float) -> Index:
    """The index of ``genome`` ([(name, codes)]) under ``pore``
    (synthgen.Pore) and ``cfg`` (IndexConfig)."""
    dim = cfg.dimension
    seqs = [(codes, synthgen.revcomp(codes)) for _, codes in genome]
    masks = kmer_masks(seqs, dim + pore.k - 1, cfg.mask_frequency)
    signals = [[zscore_f64(synthgen.expected_signal(pore, c)) for c in pair]
               for pair in seqs]
    values, groups, wpos = [], [], []
    prev = None
    for strand in (0, 1):
        for si in range(len(seqs)):
            sig = signals[si][strand]
            n_win = len(sig) - dim + 1
            if n_win <= 0:
                continue
            kept, prev = dedup(sig[:n_win], masks[si][strand],
                               cfg.dedup_delta, prev)
            values.append(sig[kept])
            groups.append(np.full(len(kept), si * 2 + strand, np.int32))
            wpos.append(kept.astype(np.int32))
    values = np.concatenate(values).astype(np.float32)
    nw = max(0, len(values) - dim + 1)
    bd = min(cfg.bucket_dims, dim)
    cw = cfg.cell_width_factor * float(np.sqrt(search_radius))
    coords = np.clip(np.floor(values / cw).astype(np.int32) + CELL_OFFSET,
                     0, CELL_RADIX - 1)
    key = np.zeros(nw, np.int32)
    for d in range(bd):
        key *= CELL_RADIX
        key += coords[d: d + nw]
    perm = np.argsort(key, kind="stable").astype(np.int32)
    cell_keys, first = np.unique(key[perm], return_index=True)
    return Index(
        dim=dim, values=values,
        win_group=np.concatenate(groups)[:nw],
        win_pos=np.concatenate(wpos)[:nw],
        ref_lengths=[len(c) for _, c in genome], cell_width=cw,
        bucket_dims=bd, cell_keys=cell_keys.astype(np.int64),
        cell_starts=np.concatenate([first, [nw]]).astype(np.int64),
        perm=perm)


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


def build_sweep(idx, radius: float, tile: int = 1024,
          span: int = SWEEP_SPAN) -> Sweep:
    """``idx``: an ``Index`` of ``build``."""
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
