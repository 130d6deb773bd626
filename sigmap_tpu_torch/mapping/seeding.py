"""Exact-engine radius search on the device.

Counterpart of ``sigmap_tpu/mapping/seeding.py`` (read its docstring for the
algorithm): probe the grid cells around each seed, expand the found ranges
into candidate slots, reject by the partial squared distance over the
leading 4 dims (an exact lower bound), then keep full distances with the
strict ``d^2 < radius`` test, under the same three budgets and overflow
flags (``cap_per_seed`` candidates per seed, ``surv_per_tile`` stage-1
survivors and ``matches_per_tile`` matches per tile of ``seeds_per_tile``
seeds).  Matches come out in the same order: tile, then seed, then probe,
then sorted window; chains are built from that order.

This is XLA code in the JAX package, not a Pallas kernel, so the port is
plain PyTorch on the device.  Left out, as TPU devices: the sequential
``lax.map`` over tiles (here as many tiles go at once as ``SEARCH_BYTES``
allows, and candidate slots are expanded to their exact count instead of a
fixed ``cap_per_tile`` buffer), the power-of-two transfer slicing and the
driver's tile-count bucketing (PyTorch does not specialise on shapes).

Squared distances are summed dim by dim in order, each f32 operation
rounded on its own (no multiply-add contraction).
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..index.build import SignalIndex

# device memory one group of tiles may take in the search: ~96 bytes per
# (seed, probe) in the probe pass, ~96 bytes per candidate slot after it
SEARCH_BYTES = 1 << 30
PROBE_BYTES = 96
SLOT_BYTES = 96


@dataclass(frozen=True)
class SearchParams:
    """Fields of ``sigmap_tpu.mapping.seeding.SearchParams`` (re-declared:
    the port imports nothing of the JAX package)."""

    radius: float = 0.08          # squared-L2 (sigmap.cc:1380)
    dim: int = 6
    bucket_dims: int = 6
    cell_width: float = 0.2828427  # sqrt(0.08)
    seeds_per_tile: int = 64
    cap_per_seed: int = 32768      # candidate budget per seed
    surv_per_tile: int = 262144    # stage-2 survivor budget per tile
    matches_per_tile: int = 32768  # compacted match budget per tile

    @property
    def probes(self) -> np.ndarray:
        """Static [P, bd] probe offset grid; per-dim span is
        ceil(2*delta/w)+1 cells."""
        delta = float(np.sqrt(self.radius))
        span = int(np.ceil(2 * delta / self.cell_width)) + 1
        return np.array(
            list(itertools.product(range(span), repeat=self.bucket_dims)),
            np.int32,
        )

    @property
    def cap_per_tile(self) -> int:
        return self.seeds_per_tile * self.cap_per_seed


@dataclass
class DeviceIndex:
    """The index arrays of the exact engine, on one device."""

    W4: torch.Tensor          # [Nw, 4] f32 leading dims (stage-1 rows)
    W8: torch.Tensor          # [Nw, 8] f32 full windows, zero-padded dims
    perm: torch.Tensor        # [Nw] i32 sorted-window -> original window idx
    win_group: torch.Tensor   # [Nw] i32 (by original window idx)
    win_pos: torch.Tensor     # [Nw] i32 (by original window idx)
    cell_keys: torch.Tensor   # [K] i32 sorted occupied cell keys
    cell_starts: torch.Tensor  # [K+1] i32
    n_windows: int
    params: SearchParams

    @staticmethod
    def from_host(idx: SignalIndex, radius: float = 0.08, *, device,
                  **tile_kw) -> "DeviceIndex":
        W = idx.windows_sorted(pad_to=8)
        params = SearchParams(
            radius=radius, dim=idx.dim, bucket_dims=idx.bucket_dims,
            cell_width=idx.cell_width, **tile_kw,
        )
        if idx.win_group is None:
            idx.derive_window_metadata()
        dev = torch.device(device)

        def put(a, dt):
            return torch.from_numpy(np.require(a, dt, ["C", "W"])).to(dev)

        return DeviceIndex(
            W4=put(W[:, :4], np.float32), W8=put(W, np.float32),
            perm=put(idx.perm, np.int32),
            win_group=put(idx.win_group, np.int32),
            win_pos=put(idx.win_pos, np.int32),
            cell_keys=put(idx.cell_keys, np.int32),
            cell_starts=put(idx.cell_starts, np.int32),
            n_windows=idx.n_windows, params=params,
        )


def _probe_ranges(dev: DeviceIndex, q, q_valid):
    """[N, 8] seeds -> per-(seed, probe) candidate ranges (starts [N, P],
    lens [N, P], i64) into the sorted window array."""
    p = dev.params
    bd = p.bucket_dims
    d = q.device
    qb = q[:, :bd]
    delta = torch.full_like(qb, float(np.float32(np.sqrt(p.radius))))
    # a full-shape divisor: CUDA divides by a host scalar through its
    # reciprocal, which rounds differently from an f32 division
    w = torch.full_like(qb, float(np.float32(p.cell_width)))
    off, radix = SignalIndex.CELL_OFFSET, SignalIndex.CELL_RADIX
    lo = torch.clamp(torch.floor((qb - delta) / w).to(torch.int64) + off,
                     0, radix - 1)
    hi = torch.clamp(torch.floor((qb + delta) / w).to(torch.int64) + off,
                     0, radix - 1)
    probes = torch.from_numpy(p.probes).to(d, torch.int64)       # [P, bd]
    valid = q_valid[:, None].expand(q.shape[0], probes.shape[0])
    key = torch.zeros(valid.shape, dtype=torch.int64, device=d)
    for k in range(bd):                       # one [N, P] plane per dim
        c = lo[:, k, None] + probes[None, :, k]
        valid = valid & (c <= hi[:, k, None])
        key = key * radix + c
    keys = dev.cell_keys.to(torch.int64)
    K = keys.shape[0]
    pos = torch.clamp(torch.searchsorted(keys, key), 0, K - 1)
    found = (keys[pos] == key) & valid
    cs = dev.cell_starts.to(torch.int64)
    starts = cs[pos]
    lens = torch.where(found, cs[pos + 1] - starts, 0)
    return starts, lens


def _sqdist(a, b, ndim: int):
    """sum_d (a_d - b_d)^2 over the first ndim columns, in order."""
    diff = a[:, 0] - b[:, 0]
    acc = diff * diff
    for k in range(1, ndim):
        diff = a[:, k] - b[:, k]
        acc = acc + diff * diff
    return acc


def _tile_rank(mask, tile, n_tiles: int):
    """Per-slot rank of mask among its tile's set slots (slots sorted by
    tile), and each tile's count of set slots.  Tile bounds come from a
    search of the sorted tile ids, not a scatter: millions of slots adding
    into a few hundred counters serialise on their atomics."""
    cs = torch.nn.functional.pad(torch.cumsum(mask.to(torch.int64), 0),
                                 (1, 0))               # cs[k] = set in [0, k)
    bounds = torch.searchsorted(
        tile, torch.arange(n_tiles + 1, device=mask.device))
    before = cs[bounds[:-1]]
    return cs[1:] - 1 - before[tile], cs[bounds[1:]] - before


def _search_tiles(dev: DeviceIndex, q, starts, lens, radius32):
    """Candidates of g whole tiles (q [g*qt, 8], capped ranges [g*qt, P])
    -> (local seed ids, window idx, d^2, surv_ovf [g], match_ovf [g])."""
    p = dev.params
    qt = p.seeds_per_tile
    n_tiles = q.shape[0] // qt
    P = starts.shape[1]
    L = lens.reshape(-1)
    S = starts.reshape(-1)
    rid = torch.repeat_interleave(torch.arange(L.shape[0], device=q.device),
                                  L)
    offs = torch.cumsum(L, 0) - L
    slot = torch.arange(rid.shape[0], device=q.device)
    cand = S[rid] + (slot - offs[rid])
    sid = torch.div(rid, P, rounding_mode="floor")
    tile = torch.div(sid, qt, rounding_mode="floor")
    # stage 1: partial distance on the leading 4 dims (exact lower bound)
    pass1 = _sqdist(dev.W4[cand], q[sid, :4], 4) < radius32
    rank, nsurv = _tile_rank(pass1, tile, n_tiles)
    keep = pass1 & (rank < p.surv_per_tile)
    cand, sid, tile = cand[keep], sid[keep], tile[keep]
    # stage 2: full distance, strict < radius (nanoflann.hpp:249)
    d2 = _sqdist(dev.W8[cand], q[sid], 8)
    match = d2 < radius32
    rank, nmatch = _tile_rank(match, tile, n_tiles)
    keep = match & (rank < p.matches_per_tile)
    return (sid[keep], dev.perm[cand[keep]], d2[keep],
            nsurv > p.surv_per_tile, nmatch > p.matches_per_tile)


def search_flat(dev: DeviceIndex, seeds, seeds_valid, n_tiles: int):
    """Radius search over a flat, padded seed array [n_tiles*qt, 8] on the
    index's device.  Returns (sid [M], widx [M], dist [M], total, n_cand,
    ovf [3]) with the M matches in compaction order; ovf flags the seed,
    survivor and match budgets."""
    p = dev.params
    qt = p.seeds_per_tile
    d = dev.W8.device
    seeds = torch.as_tensor(seeds, dtype=torch.float32).to(d)
    valid = torch.as_tensor(seeds_valid, dtype=torch.bool).to(d)
    P = p.probes.shape[0]
    radius32 = float(np.float32(p.radius))
    group = max(1, SEARCH_BYTES // (qt * P * PROBE_BYTES))
    outs = [[], [], []]
    n_cand = 0
    ovf = torch.zeros(3, dtype=torch.bool, device=d)
    for t0 in range(0, n_tiles, group):
        t1 = min(n_tiles, t0 + group)
        q = seeds[t0 * qt: t1 * qt]
        starts, lens = _probe_ranges(dev, q, valid[t0 * qt: t1 * qt])
        # per-seed candidate budget (the reference caps matches at 5000 a
        # seed, spatial_index.cc:290,371-372; this caps candidates upstream)
        row_cum = torch.cumsum(lens, dim=1)
        allowed = torch.clamp(p.cap_per_seed - (row_cum - lens), min=0)
        seed_ovf = (lens > allowed).any()
        lens = torch.minimum(lens, allowed)
        per_tile = lens.view(t1 - t0, -1).sum(dim=1).tolist()
        n_cand += sum(per_tile)
        ovf[0] |= seed_ovf
        # tiles whose candidate slots fit the budget go together
        a = 0
        while a < t1 - t0:
            b, slots = a + 1, per_tile[a]
            while b < t1 - t0 and \
                    (slots + per_tile[b]) * SLOT_BYTES <= SEARCH_BYTES:
                slots += per_tile[b]
                b += 1
            sl = slice(a * qt, b * qt)
            sid, widx, dist, s_ovf, m_ovf = _search_tiles(
                dev, q[sl], starts[sl], lens[sl], radius32)
            outs[0].append(sid + (t0 + a) * qt)
            outs[1].append(widx)
            outs[2].append(dist)
            ovf[1] |= s_ovf.any()
            ovf[2] |= m_ovf.any()
            a = b
    f_sid, f_widx, f_dist = (torch.cat(o) for o in outs)
    return f_sid, f_widx, f_dist, f_sid.shape[0], n_cand, ovf


def flatten_matches(out, params: SearchParams):
    """Device matches -> host (sids, widx, dist, n_cand, ovf) numpy arrays."""
    f_sid, f_widx, f_dist, _total, nc, ovf = out
    return (f_sid.cpu().numpy(), f_widx.cpu().numpy(), f_dist.cpu().numpy(),
            int(nc), ovf.cpu().numpy())


def seed_candidate_counts(dev: DeviceIndex, seeds, valid):
    """Per-seed candidate totals from the probe pass only (cheap)."""
    return _probe_ranges(dev, seeds, valid)[1].sum(dim=1)


def autotune_params(dev: DeviceIndex, n_sample: int = 512,
                    noise: float = 0.12, seed: int = 0,
                    max_cap: int = 65536) -> SearchParams:
    """Size the per-seed candidate budget from the index itself: sample
    queries = index windows + event-level noise; cap_per_seed = ~p99 of
    their probe candidate totals (seeding.py:290-322)."""
    rng = np.random.default_rng(seed)
    p = dev.params
    W = dev.W8[:: max(1, dev.n_windows // n_sample)][:n_sample].cpu().numpy()
    q = W + np.concatenate(
        [rng.normal(0, noise, (len(W), p.dim)).astype(np.float32),
         np.zeros((len(W), 8 - p.dim), np.float32)], axis=1,
    )
    qt = p.seeds_per_tile
    pad = (-len(q)) % qt
    if pad:
        q = np.concatenate([q, np.zeros((pad, 8), np.float32)])
    d = dev.W8.device
    counts = seed_candidate_counts(
        dev, torch.from_numpy(q).to(d),
        torch.from_numpy(np.arange(len(q)) < n_sample).to(d),
    ).cpu().numpy()[:n_sample]
    p99 = float(np.percentile(counts, 99)) if len(counts) else 1024.0
    cap = 1 << int(np.ceil(np.log2(max(256.0, min(p99 * 1.5, max_cap)))))
    surv = min(max(qt * cap // 8, 16384), 262144)
    return dataclasses.replace(p, cap_per_seed=cap, surv_per_tile=surv)


def pad_seeds(windows: np.ndarray, params: SearchParams):
    """Pad a [Q, 8] seed array up to a whole number of tiles."""
    qt = params.seeds_per_tile
    n = len(windows)
    n_tiles = max(1, -(-n // qt))
    out = np.zeros((n_tiles * qt, windows.shape[1]), np.float32)
    out[:n] = windows
    valid = np.zeros(n_tiles * qt, bool)
    valid[:n] = True
    return out, valid, n_tiles
