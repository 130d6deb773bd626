"""The exact engine's radius search (sigmap_tpu_torch.mapping.seeding) vs
sigmap_tpu.mapping.seeding, on tests/test_index_seeding.py:103's inputs
(100 kb genome, 40 noisy index windows + 8 pure-noise queries).

* ``DeviceIndex`` arrays, candidate counts, overflow flags and
  ``autotune_params`` are equal.
* Per-seed match sets are equal except pairs inside the f32 boundary band
  |d^2 - radius| <= 1e-6: XLA's CPU backend contracts the squared-distance
  sums into fused multiply-adds, the port rounds every f32 operation (as the
  CUDA kernels do), so a pair that close to the radius may fall on either
  side.  Distances of common pairs agree within 1e-6.
* With budgets small enough to overflow, the truncated match lists are
  equal in order too: the port compacts tile, then seed, then probe, then
  window, like the JAX package.
"""

import numpy as np
import pytest
import torch

from sigmap_tpu.config import IndexConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.mapping import seeding as J
from sigmap_tpu_torch.mapping import seeding as P

RADIUS = 0.08
BAND = 1e-6
KW = dict(seeds_per_tile=16, cap_per_seed=8192, surv_per_tile=16384,
          matches_per_tile=8192)
TIGHT = dict(seeds_per_tile=16, cap_per_seed=256, surv_per_tile=32,
             matches_per_tile=8)


@pytest.fixture(scope="module")
def setup(pore6, tiny_genome):
    seqs = [ReferenceSequence(n, c) for n, c in tiny_genome]
    idx = build_index(seqs, pore6, IndexConfig(), verbose=False)
    rng = np.random.default_rng(3)
    W = np.lib.stride_tricks.sliding_window_view(idx.values, idx.dim)
    qi = rng.integers(0, idx.n_windows, 40)
    noisy = W[qi] + rng.normal(0, 0.1, (40, idx.dim)).astype(np.float32)
    pure = rng.normal(0, 1, (8, idx.dim)).astype(np.float32)
    queries = np.concatenate([noisy, pure]).astype(np.float32)
    q8 = np.zeros((len(queries), 8), np.float32)
    q8[:, : idx.dim] = queries
    return idx, q8


def _both(idx, q8, kw):
    jd = J.DeviceIndex.from_host(idx, radius=RADIUS, **kw)
    pd = P.DeviceIndex.from_host(idx, radius=RADIUS, device="cpu", **kw)
    seeds, valid, n_tiles = J.pad_seeds(q8, jd.params)
    ps, pv, pn = P.pad_seeds(q8, pd.params)
    np.testing.assert_array_equal(seeds, ps)
    np.testing.assert_array_equal(valid, pv)
    assert n_tiles == pn
    want = J.flatten_matches(J.search_flat(jd, seeds, valid, n_tiles),
                             jd.params)
    got = P.flatten_matches(P.search_flat(pd, seeds, valid, n_tiles),
                            pd.params)
    return jd, pd, want, got


def test_device_index_arrays_equal(setup):
    idx, _ = setup
    jd = J.DeviceIndex.from_host(idx, radius=RADIUS, **KW)
    pd = P.DeviceIndex.from_host(idx, radius=RADIUS, device="cpu", **KW)
    for f in ("W4", "W8", "perm", "win_group", "win_pos", "cell_keys",
              "cell_starts"):
        a, b = np.asarray(getattr(jd, f)), getattr(pd, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert pd.n_windows == jd.n_windows
    assert vars(pd.params) == vars(jd.params)
    np.testing.assert_array_equal(pd.params.probes, jd.params.probes)


def test_search_flat_match_sets(setup):
    idx, q8 = setup
    _, _, (js, jw, jdist, jnc, jovf), (ps, pw, pdist, pnc, povf) = _both(
        idx, q8, KW)
    assert pnc == jnc
    np.testing.assert_array_equal(povf, jovf)
    assert not povf.any()
    assert len(ps) > 100
    for qid in range(len(q8)):
        jm = dict(zip(jw[js == qid].tolist(), jdist[js == qid].tolist()))
        pm = dict(zip(pw[ps == qid].tolist(), pdist[ps == qid].tolist()))
        for w in set(jm) ^ set(pm):
            assert abs(jm.get(w, pm.get(w)) - RADIUS) <= BAND, (qid, w)
        for w in set(jm) & set(pm):
            assert abs(jm[w] - pm[w]) <= 1e-6


def test_search_flat_overflow_truncates_in_the_same_order(setup):
    idx, q8 = setup
    _, _, (js, jw, _, jnc, jovf), (ps, pw, _, pnc, povf) = _both(
        idx, q8, TIGHT)
    assert pnc == jnc
    np.testing.assert_array_equal(povf, jovf)
    assert povf.all()                 # all three budgets overflow here
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pw, jw)


def test_candidate_counts_and_autotune(setup):
    idx, q8 = setup
    jd = J.DeviceIndex.from_host(idx, radius=RADIUS, **KW)
    pd = P.DeviceIndex.from_host(idx, radius=RADIUS, device="cpu", **KW)
    seeds, valid, _ = J.pad_seeds(q8, jd.params)
    want = np.asarray(J.seed_candidate_counts(jd, seeds, valid))
    got = P.seed_candidate_counts(pd, torch.from_numpy(seeds),
                                  torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert vars(P.autotune_params(pd, max_cap=8192)) == vars(
        J.autotune_params(jd, max_cap=8192))


def test_search_groups_of_tiles_do_not_change_results(setup, monkeypatch):
    """A byte budget that forces one tile per group gives the same
    matches as one group for everything."""
    idx, q8 = setup
    pd = P.DeviceIndex.from_host(idx, radius=RADIUS, device="cpu", **KW)
    seeds, valid, n_tiles = P.pad_seeds(q8, pd.params)
    whole = P.flatten_matches(P.search_flat(pd, seeds, valid, n_tiles),
                              pd.params)
    monkeypatch.setattr(P, "SEARCH_BYTES", 1)
    split = P.flatten_matches(P.search_flat(pd, seeds, valid, n_tiles),
                              pd.params)
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a, b)
