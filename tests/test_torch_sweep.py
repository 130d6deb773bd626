"""Port of sweep_round (kernel B3's plain version and its preparation) vs
the JAX sweep_round with the Pallas kernel in interpret mode.

On the three setups of tests/test_sweep.py: cnt, wrote and the slot
contents (m_meta) match slot for slot on every seed that has no window
within |d^2 - r| < EPS of the radius.  Inside that band f32 rounding may
flip a pair: XLA's CPU backend contracts the d^2 accumulation and the seed
rotation into fused multiply-adds, while the port (like the TPU and the
CUDA kernel) rounds every f32 operation separately.  The port's match sets
also hold against brute force exactly as tests/test_sweep.py checks them.
"""

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
from sigmap_tpu_torch.mapping.sweep_search import sweep_round
from _torch_util import cuda_device  # noqa: F401 - fixture
from test_sweep import EPS, _raw_windows_by_meta


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


@pytest.mark.gpu
def test_sweep_kernel_matches_plain_on_gpu(small_index, cuda_device):
    from sigmap_tpu_torch.mapping.sweep_search import prepare_round
    from sigmap_tpu_torch.ops.sweep_kernel import (
        sweep_search, sweep_search_plain,
    )

    cfg, idx = small_index
    sw = SweepIndex.build(idx, 0.8, tile=256)
    qs, K = _queries(idx, sw, "closest_k")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in
         (qs, sw.cum, sw.tiles, sw.meta, sw.rot, sw.mu, sw.origin)]
    qr_s, bm, _ = prepare_round(t[0], t[1], sw.n_tiles, t[4], t[5], t[6],
                                0.8, sw.tile, idx.dim, 8, sw.radixes,
                                sw.span, sw.cell_width)
    kw = dict(radius=0.8, K=K, TILE=sw.tile, dim=idx.dim, block=8)
    for a, b in zip(sweep_search(qr_s, bm, t[2], t[3], **kw),
                    sweep_search_plain(qr_s, bm, t[2], t[3], **kw)):
        assert torch.equal(a, b)
