"""Port of sweep_round (kernel B3's plain version and its preparation) vs
the JAX sweep_round with the Pallas kernel in interpret mode.

On the three setups of tests/test_sweep.py: cnt, wrote and the slot
contents (m_meta) match slot for slot on every seed that has no window
within |d^2 - r| < EPS of the radius.  Inside that band f32 rounding may
flip a pair: XLA's CPU backend contracts the d^2 accumulation and the seed
rotation into fused multiply-adds, while the port (like the TPU and the
CUDA kernel) rounds every f32 operation separately.  The port's match sets
also hold against brute force exactly as tests/test_sweep.py checks them.

The CUDA kernel's algorithm (a sparse candidate list per seed and tile,
filled in no particular order, drained by (value, lane) minima, with the
dense scan when the list overflows) is modelled in numpy here and held
exactly against the plain version on chip_smoke.py's adversarial inputs
(ties, overflow, padding seeds; dims 1, 6, 8).  prepare_round's merged
tile intervals hold every window within the radius of a block's seeds, and
running the blocks longest first leaves sweep_round's outputs unchanged.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.index.sweep import SweepIndex
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.mapping.sweep_search import SEED_PAD
from sigmap_tpu.mapping.sweep_search import sweep_round as jax_sweep_round
from sigmap_tpu.synth import random_genome
from sigmap_tpu_torch.mapping.sweep_search import (longest_first,
                                                   prepare_round, sweep_round)
from sigmap_tpu_torch.ops.sweep_kernel import sweep_search_plain
from test_sweep import EPS, _raw_windows_by_meta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import sweep_adversarial  # noqa: E402


@pytest.fixture(scope="module")
def small_index():
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(20000, seed=3)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    return cfg, idx


def _queries(idx, sw, setup):
    W, _ = _raw_windows_by_meta(idx)
    if setup == "brute":
        rng = np.random.default_rng(0)
        Q = 64
        picks = rng.integers(0, sw.n_windows, Q // 2)
        qs = np.zeros((Q, 8), np.float32)
        qs[: Q // 2, : idx.dim] = W[picks] + rng.normal(
            0, 0.08, (Q // 2, idx.dim)).astype(np.float32)
        qs[Q // 2: -8, : idx.dim] = rng.normal(
            0, 1, (Q // 2 - 8, idx.dim)).astype(np.float32)
        qs[-8:, : idx.dim] = SEED_PAD
        return qs, 48
    if setup == "dense":
        return np.zeros((32, 8), np.float32), 8
    rng = np.random.default_rng(7)
    Q = 32
    picks = rng.integers(0, sw.n_windows, Q)
    qs = np.zeros((Q, 8), np.float32)
    qs[:, : idx.dim] = W[picks] + rng.normal(
        0, 0.1, (Q, idx.dim)).astype(np.float32)
    return qs, 4


SETUPS = {"brute": 0.08, "dense": 0.08, "closest_k": 0.8}


def _run_both(small_index, setup, block=128):
    cfg, idx = small_index
    radius = SETUPS[setup]
    sw = SweepIndex.build(idx, radius, tile=256)
    qs, K = _queries(idx, sw, setup)
    geo = dict(radius=radius, K=K, TILE=sw.tile, radixes=sw.radixes,
               span=sw.span, cell_width=sw.cell_width)
    want = jax_sweep_round(
        jnp.asarray(qs), jnp.asarray(sw.cum), jnp.asarray(sw.tiles),
        jnp.asarray(sw.meta), jnp.asarray(sw.rot), jnp.asarray(sw.mu),
        jnp.asarray(sw.origin), interpret=True, block=block, **geo)
    got = sweep_round(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (qs, sw.cum, sw.tiles, sw.meta, sw.rot, sw.mu, sw.origin)),
        block=block, **geo)
    return (idx, qs, radius, K, [np.asarray(x) for x in want],
            [x.numpy() for x in got])


def _boundary_seeds(idx, qs, radius):
    W, _ = _raw_windows_by_meta(idx)
    out = np.zeros(len(qs), bool)
    for i, q in enumerate(qs):
        d2 = ((W - q[None, : idx.dim]) ** 2).sum(axis=1)
        out[i] = bool((np.abs(d2 - radius) < EPS).any())
    return out


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_port_sweep_round_matches_jax(small_index, setup):
    idx, qs, radius, K, (jm, jd, jc, jw), (pm, pd, pc, pw) = _run_both(
        small_index, setup)
    band = _boundary_seeds(idx, qs, radius)
    ok = ~band
    assert ok.sum() >= len(qs) // 2
    np.testing.assert_array_equal(pc[ok], jc[ok])
    np.testing.assert_array_equal(pw[ok], jw[ok])
    np.testing.assert_array_equal(pm[ok], jm[ok])
    # distances: the same windows, up to f32 rounding of the two bases
    np.testing.assert_allclose(pd[ok], jd[ok], rtol=1e-5, atol=1e-6)
    assert pw.max() > 0


def test_port_sweep_matches_brute(small_index):
    idx, qs, radius, K, _, (m_meta, m_d2, cnt, wrote) = _run_both(
        small_index, "brute")
    W, metas = _raw_windows_by_meta(idx)
    meta_to_d2 = {}
    for i in range(len(qs) - 8):
        d2 = ((W - qs[i, None, : idx.dim]) ** 2).sum(axis=1)
        inner, outer = d2 < radius - EPS, d2 < radius + EPS
        want_inner = {int(m) for m in metas[inner]}
        want_outer = {int(m) for m in metas[outer]}
        got = {int(m) for m in m_meta[i, : wrote[i]]}
        assert inner.sum() <= cnt[i] <= outer.sum(), f"seed {i}"
        if outer.sum() <= K:
            assert want_inner <= got <= want_outer, f"seed {i}"
        else:
            assert got <= want_outer, f"seed {i}"
        meta_to_d2 = {int(m): d for m, d in zip(metas, d2)}
        for s in range(wrote[i]):
            assert abs(meta_to_d2[int(m_meta[i, s])] - m_d2[i, s]) < 5e-4
    assert (cnt[-8:] == 0).all() and (wrote[-8:] == 0).all()


def test_port_sweep_block_size_invariant(small_index):
    """A seed's slots depend only on its own candidates in tile order: the
    seed block size changes nothing."""
    a = _run_both(small_index, "closest_k", block=8)[5]
    b = _run_both(small_index, "closest_k", block=32)[5]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


INF32 = np.float32(1.0e30)


def _tau(sd, wrote, K, r32):
    return min(sd.max(), r32) if wrote >= K else r32


def sparse_drain_model(seeds, bm, tiles, meta, radius, K, TILE, dim, block,
                       cap, rng):
    """numpy model of the CUDA kernel (csrc/sweep.cu): per seed and tile the
    candidates (d^2 < radius and < the tile-start tau) go to a list in a
    scrambled order; a list of more than `cap` entries is replaced by the
    dense candidate set, as the kernel's dense path recomputes it.  Each wave
    takes every row group's (value, lane) minimum, inserts them in group
    order and retires them, while a remaining candidate is below tau."""
    Q = len(seeds)
    NO = (bm.shape[0] - 1) // 2
    rowsz = TILE // 8
    r32 = np.float32(radius)
    out_m = np.zeros((Q, K), np.int32)
    out_d = np.zeros((Q, K), np.float32)
    cnt = np.zeros((Q, 2), np.int32)
    n_overflow = 0
    for q in range(Q):
        g = q // block
        starts, cums = bm[:NO, g], bm[NO:, g]
        sd = np.full(K, INF32, np.float32)
        sm = np.zeros(K, np.int32)
        wrote = total = 0
        for step in range(int(cums[NO])):
            t = starts[0] + step
            for oo in range(1, NO):
                if cums[oo] <= step:
                    t = starts[oo] + (step - cums[oo])
            with np.errstate(over="ignore"):     # store padding: inf
                diff = tiles[t, 0] - seeds[q, 0]
                acc = diff * diff
                for d in range(1, dim):
                    diff = tiles[t, d] - seeds[q, d]
                    acc = acc + diff * diff
            match = acc < r32
            total += int(match.sum())
            cand = np.nonzero(match & (acc < _tau(sd, wrote, K, r32)))[0]
            if len(cand) > cap:
                n_overflow += 1
            else:
                cand = rng.permutation(cand)
            alive = [(acc[w], int(w)) for w in cand]
            while alive:
                mins = [min((e for e in alive if e[1] // rowsz == r),
                            default=None) for r in range(8)]
                if not min(e for e in mins if e)[0] < _tau(sd, wrote, K,
                                                           r32):
                    break
                c_wrote, n_put = wrote, 0
                for m in mins:
                    worst = sd.max()
                    wi = int(np.argmax(sd == worst))
                    notfull = c_wrote + n_put < K
                    slot = c_wrote + n_put if notfull else wi
                    if m is not None and (notfull or m[0] < worst):
                        sm[slot] = meta.reshape(-1)[t * TILE + m[1]]
                        sd[slot] = m[0]
                        n_put += notfull
                wrote = c_wrote + n_put
                alive = [e for e in alive if e not in mins]
        out_m[q] = sm
        out_d[q, :wrote] = sd[:wrote]
        cnt[q] = (total, wrote)
    return out_m, out_d, cnt, n_overflow


@pytest.mark.parametrize("dim", [1, 6, 8])
@pytest.mark.parametrize("cap", [4, 64])
def test_sparse_drain_model_matches_plain(dim, cap):
    """The kernel's sparse drain (scrambled candidate lists, (value, lane)
    minima, dense path on overflow) equals sweep_search_plain exactly on
    the adversarial inputs: ties, overflow, padding seeds, no-tile block."""
    K, TILE, block = 8, 256, 8
    seeds, bm, tiles, meta, radius = sweep_adversarial(dim, TILE, K, block)
    want = sweep_search_plain(
        *(torch.from_numpy(a) for a in (seeds, bm, tiles, meta)),
        radius=radius, K=K, TILE=TILE, dim=dim, block=block)
    got = sparse_drain_model(seeds, bm, tiles, meta, radius, K, TILE, dim,
                             block, cap, np.random.default_rng(dim))
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g, w.numpy())
    m_cnt = want[2].numpy()
    assert (m_cnt[2 * block:3 * block] == 0).all()     # padding seeds
    assert (m_cnt[5 * block:] == 0).all()              # the no-tile block
    assert m_cnt[:, 0].max() > K                       # slots overflowed
    if cap == 4:
        assert got[3] > 0                              # dense path taken
    ties = [np.unique(d[:n], return_counts=True)[1].max(initial=0)
            for d, n in zip(want[1].numpy(), m_cnt[:, 1])]
    assert max(ties) > 1                               # equal d^2 in slots


def test_prepare_round_tiles_cover_every_match(small_index):
    """Each block's merged tile intervals are disjoint and ascending, and
    hold every window that lies within the radius of one of its seeds
    (brute force in raw coordinates, off the f32 boundary band)."""
    cfg, idx = small_index
    radius, block = SETUPS["brute"], 8
    sw = SweepIndex.build(idx, radius, tile=256)
    qs, _ = _queries(idx, sw, "brute")
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (qs, sw.cum, sw.rot, sw.mu, sw.origin)]
    _, bm, perm = prepare_round(t[0], t[1], sw.n_tiles, t[2], t[3], t[4],
                                radius, sw.tile, idx.dim, block, sw.radixes,
                                sw.span, sw.cell_width)
    bm, perm = bm.numpy().astype(np.int64), perm.numpy()
    NO = (bm.shape[0] - 1) // 2
    tile_of = {int(m): ti for ti, row in enumerate(sw.meta.reshape(
        sw.n_tiles, -1)) for m in row}
    W, metas = _raw_windows_by_meta(idx)
    n_matched = 0
    for g in range(bm.shape[1]):
        starts, cnts = bm[:NO, g], np.diff(bm[NO:, g])
        spans = [(a, a + c) for a, c in zip(starts, cnts) if c > 0]
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
        union = {x for a, b in spans for x in range(a, b)}
        for q in perm[g * block:(g + 1) * block]:
            if q >= len(qs):
                continue
            d2 = ((W - qs[q, None, :idx.dim]) ** 2).sum(axis=1)
            for m in metas[d2 < radius - EPS]:
                assert tile_of[int(m)] in union, (g, int(q), int(m))
                n_matched += 1
    assert n_matched >= len(qs) // 2


def test_prepare_round_gives_padding_blocks_no_tiles(small_index):
    """A block made only of SEED_PAD seeds (finished reads, and the padding
    up to a whole block) gets zero tile steps: its box is one empty corner
    cell of the grid, so the kernel does no work for it."""
    cfg, idx = small_index
    sw = SweepIndex.build(idx, 0.08, tile=256)
    qs, _ = _queries(idx, sw, "brute")
    qs = np.concatenate([qs, np.zeros((13, 8), np.float32)])
    qs[-29:, :idx.dim] = SEED_PAD        # 29 padding seeds, 3 padded up
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (qs, sw.cum, sw.rot, sw.mu, sw.origin)]
    _, bm, perm = prepare_round(t[0], t[1], sw.n_tiles, t[2], t[3], t[4],
                                0.08, sw.tile, idx.dim, 8, sw.radixes,
                                sw.span, sw.cell_width)
    NO = (bm.shape[0] - 1) // 2
    pad = np.ones(len(perm), bool)
    pad[:len(qs)] = qs[:, 0] == SEED_PAD
    blk_pad = pad[perm.numpy()].reshape(-1, 8).all(axis=1)
    steps = bm[2 * NO].numpy()
    assert blk_pad.sum() >= 3
    assert (steps[blk_pad] == 0).all() and (steps[~blk_pad] > 0).any()


def test_longest_first_leaves_sweep_round_unchanged(small_index):
    """sweep_round runs the blocks by descending tile count; its outputs
    equal those of the blocks run in prepare_round's cell-key order."""
    cfg, idx = small_index
    sw = SweepIndex.build(idx, 0.8, tile=256)
    qs, K = _queries(idx, sw, "closest_k")
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (qs, sw.cum, sw.tiles, sw.meta, sw.rot, sw.mu, sw.origin)]
    geo = dict(TILE=sw.tile, dim=idx.dim, block=8)
    key = prepare_round(t[0], t[1], sw.n_tiles, t[4], t[5], t[6], 0.8,
                        radixes=sw.radixes, span=sw.span,
                        cell_width=sw.cell_width, **geo)
    q_l, bm_l, perm_l = longest_first(*key, 8)
    steps = bm_l[-1]
    assert (steps[:-1] >= steps[1:]).all() and steps[0] > steps[-1]
    assert not torch.equal(perm_l, key[2])
    out = sweep_search_plain(key[0], key[1], t[2], t[3], radius=0.8, K=K,
                             **geo)
    want = [o[torch.argsort(key[2])][:len(qs)] for o in out]
    got = sweep_round(*t, radius=0.8, K=K, radixes=sw.radixes, span=sw.span,
                      cell_width=sw.cell_width, **geo)
    for g, w in zip(got, (want[0], want[1], want[2][:, 0], want[2][:, 1])):
        assert torch.equal(g, w)
