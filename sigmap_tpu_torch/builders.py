"""The set-up builders in plain torch on a device: the signal index
(``index/build.py:build_index``'s arrays) and the sweep tile store
(``index/sweep.py:SweepIndex.build``'s), equal to the host builders bit
for bit.

On a GPU the host builders took some 1.3 s a Mb of genome for the index
and about as long again for the tile store, so a genome of tens of Mb
spent minutes in set-up.  Here each step is a few whole-array torch
operations on the device:

* the index: 2-bit k-mer codes of both strands, their canonical codes and
  the positive strands' histogram, the mask of frequent k-mers (a float
  compare of count / k-mers, as ``csrc/core.cc:sig_kmer_mask``), the
  expected signal with the reference's rolling-hash quirk, its z-score,
  the consecutive-point dedup across streams (``dedup``), the packed
  positions and the cell grid of ``_finalize_index``;
* the tile store: the rotated windows a column at a time, the cell keys,
  a stable sort, the cumulative cell table, the tiles and the packed meta
  (``index/sweep.py:meta_pos_bits``).

Bit for bit, because integer work and compares are exact anywhere, each
float operation is one IEEE operation of a kernel of its own (a multiply
and an add of their own per term, never a fused multiply-add; a divisor is
a tensor on the device, since CUDA multiplies by the reciprocal of a host
scalar), and the reductions whose order sets a last bit are made where the
host builders make them, in numpy on the host: the z-score's float64 mean
and deviation (numpy's pairwise sums), and the PCA basis of the tile
store from a sample.  On the CPU the same code runs, which is how the
tests hold it to the host builders.
"""

from __future__ import annotations

import numpy as np
import torch

from .index.build import SignalIndex
from .index.sweep import PAD_COORD, SWEEP_SPAN, SweepIndex, bucket_dims, \
    meta_pos_bits

# candidates of the dedup walk a slice, and the offsets its first pass
# tests past a candidate (doubled each pass)
_WALK_ROWS = 1 << 22
_WALK = 16


def kmer_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """2-bit packed k-mers (i64) at every start of ``codes`` (u8;
    ambiguous bases count as A, ``utils.rolling_kmer_codes``)."""
    b = torch.where(codes < 4, codes, 0).to(torch.int64)
    n = max(codes.numel() - k + 1, 0)
    out = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for i in range(k):
        out = (out << 2) | b[i: i + n]
    return out


def _canonical(codes: torch.Tensor, k: int):
    """(canonical k-mer i64, k bases all unambiguous) at every start: the
    smaller of the k-mer and its reverse complement, as the core's rolling
    registers give them on a run of k unambiguous bases."""
    n = max(codes.numel() - k + 1, 0)
    bad = codes >= 4
    b = torch.where(bad, 0, codes).to(torch.int64)
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for i in range(k):
        fwd = (fwd << 2) | b[i: i + n]
        rc = rc | ((3 ^ b[i: i + n]) << (2 * i))
    runs = torch.cat([bad.new_zeros(1, dtype=torch.int32),
                      torch.cumsum(bad, 0, dtype=torch.int32)])
    ok = (runs[k: k + n] - runs[:n]) == 0
    return torch.minimum(fwd, rc), ok


def kmer_masks(strands: list, k: int, frequency: float) -> list:
    """``native.kmer_masks`` for [(positive codes, negative codes)] of
    every sequence: [(positive mask, negative mask)] (bool).  A window of
    k unambiguous bases is masked where its canonical k-mer's count over
    the positive strands, over their k-mers, is above ``frequency`` (f32);
    a window ending on an ambiguous base is masked; other windows with one
    are not."""
    size = 1 << (2 * k)
    dev = strands[0][0].device
    hist = torch.zeros(size, dtype=torch.int64, device=dev)
    num = 0
    for pos, _ in strands:
        canon, ok = _canonical(pos, k)
        sel = canon[ok]
        hist += torch.bincount(sel, minlength=size)
        num += sel.numel()
    frac = hist.cpu().numpy().astype(np.float32) / np.float32(num)
    frequent = torch.from_numpy(frac > np.float32(frequency)).to(dev)
    del hist
    out = []
    for pair in strands:
        masks = []
        for codes in pair:
            canon, ok = _canonical(codes, k)
            m = torch.where(ok, frequent[torch.where(ok, canon, 0)], False)
            masks.append(m | (codes[k - 1:] >= 4))
        out.append(tuple(masks))
    return out


def expected_signal(level_mean: torch.Tensor, codes: torch.Tensor,
                    k: int) -> torch.Tensor:
    """``PoreModel.expected_signal``: level means a position, out[0] from
    the k-mer at 0, out[i >= 1] from the k-mer at i + 1 (an A shifted in
    past the end)."""
    n = codes.numel()
    if n < k:
        raise ValueError("sequence shorter than k")
    km = kmer_codes(torch.cat([codes, codes.new_zeros(1)]), k)
    return level_mean[torch.cat([km[:1], km[2: n - k + 2]])]


def zscore_f64(x: torch.Tensor) -> torch.Tensor:
    """``build.zscore_f64``: the mean and the sample deviation summed in
    float64 by numpy on the host, the elementwise part on the device."""
    x64 = x.cpu().numpy().astype(np.float64)
    mean = x64.mean()
    sd = np.sqrt(((x64 - mean) ** 2).sum() / (len(x64) - 1))
    del x64

    def t(v):
        return torch.tensor(v, dtype=torch.float64, device=x.device)

    return ((x.to(torch.float64) - t(mean)) / t(sd)).to(torch.float32)


def _next_kept(u, forced, d, cand) -> torch.Tensor:
    """For each candidate j: the first later window that is forced or more
    than ``d`` from u[j] (n where there is none), in slices of
    _WALK_ROWS candidates and widening steps."""
    n = u.numel()
    dev = u.device
    nxt = torch.empty_like(cand)
    for lo in range(0, cand.numel(), _WALK_ROWS):
        pend = torch.arange(lo, min(lo + _WALK_ROWS, cand.numel()),
                            device=dev)
        o, w = 2, _WALK
        while pend.numel():
            j = cand[pend]
            kk = j[:, None] + torch.arange(o, o + w, device=dev)[None, :]
            kc = torch.clamp(kk, max=n - 1)
            stop = ((kk >= n) | forced[kc]
                    | ((u[kc] - u[j][:, None]).abs() > d))
            hit = stop.any(dim=1)
            first = stop.to(torch.int8).argmax(dim=1)
            nxt[pend[hit]] = j[hit] + o + first[hit]
            pend = pend[~hit]
            o += w
            w = min(2 * w, 4096)
    return nxt


def dedup(u: torch.Tensor, forced: torch.Tensor, delta: float):
    """``csrc/core.cc:sig_dedup_stream`` over the unmasked windows of every
    stream, concatenated in stream order: a window is kept if ``forced`` (a
    stream's position 0, or the first window of all) or it differs from the
    last kept one by more than ``delta`` (f32).  Returns the keep mask.

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
    if n < 2:
        return keep
    d = torch.tensor(delta, dtype=torch.float32, device=dev)
    cand = torch.nonzero(((u[1:] - u[:-1]).abs() <= d)
                         & ~forced[1:]).squeeze(1)
    m = cand.numel()
    if m == 0:
        return keep
    nxt = _next_kept(u, forced, d, cand)
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
    edge.index_add_(0, cand[on] + 1,
                    torch.ones_like(cand[on], dtype=torch.int32))
    edge.index_add_(0, nxt[on],
                    torch.full_like(nxt[on], -1, dtype=torch.int32))
    return torch.cumsum(edge[:n], 0) == 0


def cell_grid(values: torch.Tensor, dim: int, bd: int, cw: float):
    """``build._finalize_index``'s grid: the windows sorted (stably) by the
    cell key of their first ``bd`` values, and the occupied keys with their
    first window in that order: (perm i32, cell_keys i32, cell_starts
    i32)."""
    nw = max(0, values.numel() - dim + 1)
    dev = values.device
    cwt = torch.tensor(cw, dtype=torch.float32, device=dev)
    coords = torch.clamp(
        torch.floor(values / cwt).to(torch.int32) + SignalIndex.CELL_OFFSET,
        0, SignalIndex.CELL_RADIX - 1)
    key = torch.zeros(nw, dtype=torch.int32, device=dev)
    for d in range(bd):
        key = key * SignalIndex.CELL_RADIX + coords[d: d + nw]
    del coords
    sk, perm = torch.sort(key, stable=True)
    del key
    cell_keys, counts = torch.unique_consecutive(sk, return_counts=True)
    del sk
    starts = torch.cumsum(counts, 0) - counts
    return (perm.to(torch.int32), cell_keys.to(torch.int32),
            torch.cat([starts, starts.new_tensor([nw])]).to(torch.int32))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _release(dev: torch.device) -> None:
    """Give the caching allocator's free blocks back to the card."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def build_index(seqs, pore, cfg, search_radius: float,
                device) -> SignalIndex:
    """``index/build.py:build_index`` (its host path with the native core)
    on ``device``: the same SignalIndex, its arrays on the host."""
    dev = torch.device(device)
    dim = cfg.dimension
    k = pore.k
    k_mask = dim + k - 1
    for s in seqs:
        s.prepare_negative()
    strands = [tuple(torch.from_numpy(np.ascontiguousarray(c, np.uint8))
                     .to(dev) for c in (s.codes, s.neg_codes)) for s in seqs]
    masks = kmer_masks(strands, k_mask, cfg.mask_frequency)
    level = torch.from_numpy(np.ascontiguousarray(pore.level_mean)).to(dev)
    signals = [tuple(zscore_f64(expected_signal(level, c, k)) for c in pair)
               for pair in strands]
    del strands
    us, packed = [], []
    for strand in (0, 1):     # every positive strand, then every negative
        for si in range(len(seqs)):
            sig = signals[si][strand]
            n_win = sig.numel() - dim + 1
            if n_win <= 0:
                continue
            kept = torch.nonzero(~masks[si][strand][:n_win]).squeeze(1)
            us.append(sig[kept])
            packed.append((si << 33) | (kept << 1) | strand)
    del signals, masks
    if us:
        u = torch.cat(us)
        pos = torch.cat(packed)
        del us, packed
        forced = (pos & ((1 << 33) - 2)) == 0
        forced[:1] = True
        keep = dedup(u, forced, cfg.dedup_delta)
        values, positions = u[keep], pos[keep]
        del u, pos, forced, keep
    else:
        values = torch.zeros(0, dtype=torch.float32, device=dev)
        positions = torch.zeros(0, dtype=torch.int64, device=dev)
    bd = min(cfg.bucket_dims, dim)
    if SignalIndex.CELL_RADIX ** bd > 2**31:
        raise ValueError(f"bucket_dims={bd} overflows int32 cell keys")
    cw = cfg.cell_width_factor * float(np.sqrt(search_radius))
    perm, cell_keys, cell_starts = cell_grid(values, dim, bd, cw)
    idx = SignalIndex(
        dim=dim, max_leaf=cfg.max_leaf, bucket_dims=bd, cell_width=cw,
        values=_host(values), positions=_host(positions).view(np.uint64),
        perm=_host(perm), cell_keys=_host(cell_keys),
        cell_starts=_host(cell_starts),
        ref_names=[s.name for s in seqs],
        ref_lengths=[s.length for s in seqs],
    )
    del values, positions, perm, cell_keys, cell_starts
    _release(dev)
    idx.derive_window_metadata()
    return idx


def pca_basis(values: np.ndarray, nw: int, dim: int):
    """``SweepIndex.build``'s (mu, rot), float64, from every
    (nw // 300,000)-th window."""
    view = np.lib.stride_tricks.sliding_window_view(values, dim)[:nw]
    samp = view[:: max(1, nw // 300_000)].astype(np.float64)
    mu = samp.mean(axis=0) if len(samp) else np.zeros(dim)
    if len(samp) > dim:
        cov = np.cov((samp - mu).T)
        evals, evecs = np.linalg.eigh(np.atleast_2d(cov))
        rot = evecs[:, np.argsort(evals)[::-1]]
    else:
        rot = np.eye(dim)
    return mu, rot


def sweep_store(idx: SignalIndex, radius: float, tile: int = 1024,
                span: int = SWEEP_SPAN, device="cpu"):
    """``SweepIndex.build(idx, radius, tile, span)`` with its tiles and
    meta built on ``device``: (sw, tiles [T, 8, tile] f32, meta
    [T, 8, tile // 8] i32), where ``sw`` holds everything else on the host
    (its ``tiles``, ``meta`` and ``meta_flat`` None).  On a GPU the tiles
    and meta are the first blocks taken from an emptied cache and the
    temporaries' blocks are given back at the end, so that the store holds
    the card's memory as an upload of the host store does."""
    dev = torch.device(device)
    nw = idx.n_windows
    dim = idx.dim
    if dim < 2:
        raise ValueError("sweep layout needs index dim >= 2")
    if dim > 8:
        raise ValueError("sweep layout packs windows into 8 f32 rows")
    if idx.win_group is None:
        idx.derive_window_metadata()
    pos_bits = meta_pos_bits(2 * len(idx.ref_names),
                             int(idx.win_pos[:nw].max(initial=0)))
    bd = bucket_dims(dim)
    w = 2.0 * float(np.sqrt(radius)) / (span - 1)
    T = max(1, -(-nw // tile))
    _release(dev)
    tiles = torch.zeros((T, 8, tile), dtype=torch.float32, device=dev)
    meta = torch.zeros((T, 8, tile // 8), dtype=torch.int32, device=dev)
    mu, rot = pca_basis(idx.values, nw, dim)
    rot_f = rot.astype(np.float32)
    base = -(mu @ rot).astype(np.float32)
    vals = torch.from_numpy(np.ascontiguousarray(idx.values, np.float32)
                            ).to(dev)
    rot_t = torch.from_numpy(rot_f).to(dev)
    # the rotated windows a column each, every term a multiply and an add
    # of its own in dim order (SweepIndex.build's WR += vals * rot_f)
    cols = []
    for j in range(dim):
        c = torch.full((nw,), float(base[j]), dtype=torch.float32,
                       device=dev)
        for d in range(dim):
            c = c + vals[d: d + nw] * rot_t[d, j]
        cols.append(c)
    del vals
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
        del coord
    perm = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=keyspace)
    del key
    cum = np.zeros(keyspace + 1, np.int32)
    np.cumsum(_host(counts), out=cum[1:])
    del counts
    # [T, 8, tile]: a tile's windows transposed, the pads PAD_COORD in
    # row 0 and 0 in the others
    for j in range(dim):
        row = torch.empty(T * tile, dtype=torch.float32, device=dev)
        row[:nw] = cols[j][perm]
        row[nw:] = PAD_COORD if j == 0 else 0.0
        tiles[:, j, :] = row.view(T, tile)
        cols[j] = row = None
    group = torch.from_numpy(np.ascontiguousarray(idx.win_group[:nw])
                             ).to(dev)
    wpos = torch.from_numpy(np.ascontiguousarray(idx.win_pos[:nw])).to(dev)
    meta.view(-1)[:nw] = (group[perm] << pos_bits) | wpos[perm]
    del group, wpos
    sw = SweepIndex(
        tiles=None, meta=None, cum=cum, rot=rot.astype(np.float32),
        mu=mu.astype(np.float32), origin=origin.astype(np.float32),
        radixes=radixes, span=span, n_windows=nw, tile=tile, dim=dim,
        cell_width=w, radius=float(radius),
        perm=_host(perm.to(torch.int32)), meta_flat=None, pos_bits=pos_bits,
    )
    del perm, cols
    _release(dev)
    return sw, tiles, meta


def materialize(sw: SweepIndex, tiles: torch.Tensor,
                meta: torch.Tensor) -> SweepIndex:
    """``sw`` of ``sweep_store`` with its tiles, meta and meta_flat copied
    to the host, as ``SweepIndex.build`` returns it."""
    import dataclasses

    m = _host(meta)
    return dataclasses.replace(sw, tiles=_host(tiles), meta=m,
                               meta_flat=m.reshape(-1)[:sw.n_windows].copy())
