"""The signal index, worked out again from the genome and the pore model,
in plain torch on the reference's device.

The semantics of the port's ``index/build.py:build_index`` with its
native core (``csrc/core.cc``: ``sig_kmer_count`` / ``sig_kmer_mask``
masking with a float compare, ``sig_dedup_stream``): canonical k-mer
masking of high-frequency windows, the z-scored expected signal of both
strands, consecutive-point dedup across streams (positive strands of
every sequence, then negative), the windows' metadata, and the cell grid
of ``_finalize_index`` (which the rescue's radius search probes).

Every array equals the numpy builder's that it replaced
(``benchmark/tests/numpy_oracle.py``) bit for bit: integer work and
compares are exact anywhere, each float operation is one IEEE operation
of its own kernel (no fused multiply-add, a divisor is a tensor on the
device, since CUDA multiplies by the reciprocal of a host scalar), and
the two reductions whose order sets a last bit, the z-score's mean and
deviation in float64, run in numpy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CELL_OFFSET = 17
CELL_RADIX = 35

# the offsets a dedup walk tests at once, past its first
_WALK = 16


@dataclass
class Index:
    """The index on the device."""

    dim: int
    values: torch.Tensor       # f32 [N] deduped point values
    win_group: torch.Tensor    # i32 [Nw] sequence * 2 + strand
    win_pos: torch.Tensor      # i32 [Nw] position on the strand's signal
    ref_lengths: list
    cell_width: float
    bucket_dims: int
    cell_keys: torch.Tensor    # i64 sorted occupied cell keys
    cell_starts: torch.Tensor  # i64 [K + 1] offsets into ``perm``
    perm: torch.Tensor         # i32 [Nw] windows sorted by cell key

    @property
    def n_windows(self) -> int:
        return max(0, self.values.numel() - self.dim + 1)


def kmer_codes(codes, k: int):
    """2-bit packed k-mers (i64) at every start of ``codes`` (u8; ambiguous
    -> A)."""
    b = torch.where(codes < 4, codes, 0).to(torch.int64)
    n = max(codes.numel() - k + 1, 0)
    out = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for i in range(k):
        out = (out << 2) | b[i: i + n]
    return out


def revcomp(codes):
    rev = codes.flip(0)
    return torch.where(rev > 3, 4, 3 ^ rev).to(torch.uint8)


def expected_signal(level_mean, codes, k: int):
    """Per-position level means with the reference's rolling-hash quirk:
    out[0] from the k-mer at 0, out[i >= 1] from the k-mer at i + 1 (an A
    shifted in past the end)."""
    km = kmer_codes(torch.cat([codes, codes.new_zeros(1)]), k)
    n = codes.numel()
    return level_mean[torch.cat([km[:1], km[2: n - k + 2]])]


def kmer_masks(seqs, k: int, frequency: float):
    """Masks of windows whose canonical k-mer is frequent: a float compare
    of count / k-mers against ``frequency`` (core.cc:sig_kmer_mask); the
    histogram counts the positive strands.  The negative strand's canonical
    k-mers are the positive strand's reversed.  Every base is
    unambiguous."""
    size = 1 << (2 * k)
    dev = seqs[0][0].device
    hist = torch.zeros(size, dtype=torch.int64, device=dev)
    canon = []
    for codes, neg in seqs:
        c = torch.minimum(kmer_codes(codes, k), kmer_codes(neg, k).flip(0))
        hist += torch.bincount(c, minlength=size)
        canon.append(c.to(torch.int32))
    num = np.float32(sum(c.numel() for c in canon))
    frac = hist.cpu().numpy().astype(np.float32) / num
    frequent = torch.from_numpy(frac > np.float32(frequency)).to(dev)
    return [(frequent[c], frequent[c].flip(0)) for c in canon]


def zscore_f64(x):
    """(x - mean) / sd in float64, cast to f32: the mean and the sample
    deviation summed by numpy on the host, the elementwise part here."""
    x64 = x.cpu().numpy().astype(np.float64)
    mean = x64.mean()
    sd = np.sqrt(((x64 - mean) ** 2).sum() / (len(x64) - 1))
    del x64

    def t(v):
        return torch.tensor(v, dtype=torch.float64, device=x.device)

    return ((x.to(torch.float64) - t(mean)) / t(sd)).to(torch.float32)


def dedup(u, forced, delta: float):
    """core.cc:sig_dedup_stream over the unmasked windows of every stream,
    concatenated in stream order: a window is kept if ``forced`` (a
    stream's first position, or the first window of all) or it differs
    from the last kept value by more than ``delta`` (f32).  Returns the
    keep mask.

    From a kept window j the next kept one is nxt(j), the first later
    window that is forced or more than delta from u[j]; the kept windows
    are the chain 0, nxt(0), ...  Mostly nxt(j) = j + 1; the candidates,
    whose next neighbour lies within delta, are walked out to their nxt,
    and the candidates on the chain found by pointer doubling: each
    candidate's successor is the first candidate at or past its nxt, and
    the chain's candidates are those reached from the first one."""
    n = u.numel()
    dev = u.device
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    d = torch.tensor(delta, dtype=torch.float32, device=dev)
    cand = torch.nonzero(((u[1:] - u[:-1]).abs() <= d)
                         & ~forced[1:]).squeeze(1)
    m = cand.numel()
    if m == 0:
        return keep
    nxt = torch.empty_like(cand)
    pend = torch.arange(m, device=dev)
    o = 2
    while pend.numel():
        j = cand[pend]
        kk = j[:, None] + torch.arange(o, o + _WALK, device=dev)[None, :]
        kc = torch.clamp(kk, max=n - 1)
        stop = (kk >= n) | forced[kc] | ((u[kc] - u[j][:, None]).abs() > d)
        hit = stop.any(dim=1)
        first = stop.to(torch.int8).argmax(dim=1)
        nxt[pend[hit]] = j[hit] + o + first[hit]
        pend = pend[~hit]
        o += _WALK
    # pointer doubling over the candidates; node m is past the last
    ptr = torch.cat([torch.searchsorted(cand, nxt),
                     torch.tensor([m], device=dev)])
    on = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    on[0] = True
    while True:
        reach = torch.zeros_like(on)
        reach[ptr[on]] = True
        if not bool((reach & ~on).any()):
            break
        on |= reach
        ptr = ptr[ptr]
    on = on[:m]
    # the chain's candidates drop every window up to their nxt
    edge = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    edge.index_add_(0, cand[on] + 1, torch.ones_like(cand[on],
                                                     dtype=torch.int32))
    edge.index_add_(0, nxt[on], torch.full_like(nxt[on], -1,
                                                 dtype=torch.int32))
    return torch.cumsum(edge[:n], 0) == 0


def cell_grid(values, dim: int, bd: int, cw: float):
    """The cell key of each window (its first ``bd`` values in cells of
    width ``cw``), windows sorted by key (stable), and the occupied keys
    with their starts in that order: (perm i32, cell_keys i64,
    cell_starts i64)."""
    nw = max(0, values.numel() - dim + 1)
    dev = values.device
    cwt = torch.tensor(cw, dtype=torch.float32, device=dev)
    coords = torch.clamp(torch.floor(values / cwt).to(torch.int32)
                         + CELL_OFFSET, 0, CELL_RADIX - 1)
    key = torch.zeros(nw, dtype=torch.int32, device=dev)
    for d in range(bd):
        key = key * CELL_RADIX + coords[d: d + nw]
    sk, perm = torch.sort(key, stable=True)
    cell_keys, counts = torch.unique_consecutive(sk, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    return (perm.to(torch.int32), cell_keys.to(torch.int64),
            torch.cat([starts, starts.new_tensor([nw])]).to(torch.int64))


def build(genome, pore, cfg, search_radius: float, device="cpu") -> Index:
    """The index of ``genome`` ([(name, codes)]) under ``pore``
    (synthgen.Pore) and ``cfg`` (IndexConfig), on ``device``."""
    dev = torch.device(device)
    dim = cfg.dimension
    seqs = []
    for _, codes in genome:
        c = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev)
        seqs.append((c, revcomp(c)))
    masks = kmer_masks(seqs, dim + pore.k - 1, cfg.mask_frequency)
    level = torch.from_numpy(pore.level_mean).to(dev)
    us, groups, wpos = [], [], []
    for strand in (0, 1):
        for si, pair in enumerate(seqs):
            n_win = pair[strand].numel() - pore.k + 1 - dim + 1
            if n_win <= 0:
                continue
            sig = zscore_f64(expected_signal(level, pair[strand], pore.k))
            kept = torch.nonzero(~masks[si][strand]).squeeze(1)
            us.append(sig[kept])
            groups.append(torch.full_like(kept, si * 2 + strand,
                                          dtype=torch.int32))
            wpos.append(kept.to(torch.int32))
    u = torch.cat(us)
    pos = torch.cat(wpos)
    forced = pos == 0
    forced[:1] = True
    keep = dedup(u, forced, cfg.dedup_delta)
    values = u[keep]
    nw = max(0, values.numel() - dim + 1)
    bd = min(cfg.bucket_dims, dim)
    cw = cfg.cell_width_factor * float(np.sqrt(search_radius))
    perm, cell_keys, cell_starts = cell_grid(values, dim, bd, cw)
    return Index(
        dim=dim, values=values,
        win_group=torch.cat(groups)[keep][:nw], win_pos=pos[keep][:nw],
        ref_lengths=[len(c) for _, c in genome], cell_width=cw,
        bucket_dims=bd, cell_keys=cell_keys, cell_starts=cell_starts,
        perm=perm)
