"""The signal index, worked out again from the genome and the pore model.

The semantics of the port's ``index/build.py:build_index`` with its
native core (``csrc/core.cc``: ``sig_kmer_count`` / ``sig_kmer_mask``
masking with a float compare, ``sig_dedup_stream``), written in numpy:
canonical k-mer masking of high-frequency windows, the z-scored expected
signal of both strands, consecutive-point dedup across streams (positive
strands of every sequence, then negative), the windows' metadata, and the
cell grid of ``_finalize_index`` (which the rescue's radius search
probes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import synthgen

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
