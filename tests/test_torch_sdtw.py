"""Kernel B5's plain version (sigmap_tpu_torch.ops.sdtw_kernel) vs the JAX
package's sDTW.

* ``sdtw_plain`` vs ``sdtw_np`` and ``sdtw_pallas(interpret=True)``: exact
  (best equal as f32, ends equal).  All three compute the same recurrence
  with one f32 rounding per cell (the cost plus the minimum of three
  predecessors); there is no multiply a compiler could contract.
* ``sdtw_plain`` vs ``sdtw_batch``: the prefix-sum form accumulates the row
  cost in f32, so distances agree only to the tolerance of
  tests/test_ops.py:44 (1e-2 relative); ends are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigmap_tpu.ops.sdtw import sdtw_batch, sdtw_np
from sigmap_tpu.ops.sdtw_kernel import sdtw_pallas
from sigmap_tpu_torch import LAUNCHES
from sigmap_tpu_torch.ops.sdtw_kernel import BIG, sdtw, sdtw_plain


def _ragged(seed=42, B=4, T=256, Q=64):
    """tests/test_kernels.py:30-53's inputs, plus a pair whose query is
    longer than its target."""
    rng = np.random.default_rng(seed)
    ts = np.zeros((B + 1, T), np.float32)
    qs = np.zeros((B + 1, Q), np.float32)
    tl = np.zeros(B + 1, np.int32)
    ql = np.zeros(B + 1, np.int32)
    for b in range(B):
        nt = int(rng.integers(100, T))
        nq = int(rng.integers(30, Q))
        t = rng.normal(0, 1, nt).astype(np.float32)
        lo = int(rng.integers(0, nt - nq))
        q = (t[lo: lo + nq] + rng.normal(0, 0.05, nq)).astype(np.float32)
        ts[b, :nt], qs[b, :nq], tl[b], ql[b] = t, q, nt, nq
    ts[B, :40] = rng.normal(0, 1, 40)
    qs[B, :] = rng.normal(0, 1, Q)
    tl[B], ql[B] = 40, Q
    return ts, tl, qs, ql


def _uniform(seed=3, B=5, T=120, Q=48):
    """tests/test_kernels.py:56-74's inputs."""
    rng = np.random.default_rng(seed)
    ts = rng.normal(0, 1, (B, T)).astype(np.float32)
    qs = rng.normal(0, 1, (B, Q)).astype(np.float32)
    return ts, np.full(B, T, np.int32), qs, np.full(B, Q, np.int32)


def _port(ts, tl, qs, ql):
    best, end = sdtw_plain(*(torch.from_numpy(a) for a in (ts, tl, qs, ql)))
    assert best.dtype == torch.float32 and end.dtype == torch.int32
    return best.numpy(), end.numpy()


@pytest.mark.parametrize("inputs", [_ragged, _uniform])
def test_sdtw_plain_equals_np_and_pallas(inputs):
    ts, tl, qs, ql = inputs()
    best, end = _port(ts, tl, qs, ql)
    pb, pe = (np.asarray(x) for x in sdtw_pallas(ts, tl, qs, ql,
                                                 interpret=True))
    np.testing.assert_array_equal(best, pb)
    np.testing.assert_array_equal(end, pe)
    for b in range(len(ts)):
        nb, ne = sdtw_np(ts[b, : tl[b]], qs[b, : ql[b]])
        assert best[b] == np.float32(nb) and end[b] == ne, b


@pytest.mark.parametrize("inputs", [_ragged, _uniform])
def test_sdtw_plain_vs_prefix_sum_form(inputs):
    ts, tl, qs, ql = inputs()
    best, end = _port(ts, tl, qs, ql)
    bb, be = (np.asarray(x) for x in sdtw_batch(
        jnp.asarray(ts), jnp.asarray(tl), jnp.asarray(qs), jnp.asarray(ql)))
    for b in range(len(ts)):
        assert abs(float(best[b]) - float(bb[b])) < 1e-2 * max(1, bb[b])
    np.testing.assert_array_equal(end, be)


def test_sdtw_empty_pairs_match_pallas():
    """No valid last-column cell (t_len 0 or q_len 0): best 1e30, end -1,
    as the TPU kernel returns."""
    ts, tl, qs, ql = _uniform(B=3)
    tl[0], ql[1] = 0, 0
    best, end = _port(ts, tl, qs, ql)
    pb, pe = (np.asarray(x) for x in sdtw_pallas(ts, tl, qs, ql,
                                                 interpret=True))
    np.testing.assert_array_equal(best, pb)
    np.testing.assert_array_equal(end, pe)
    assert best[0] == best[1] == np.float32(BIG) and end[0] == end[1] == -1


def test_sdtw_wrapper_on_cpu_runs_the_plain_version():
    args = [torch.from_numpy(a) for a in _uniform()]
    before = LAUNCHES["sdtw"]
    got = sdtw(*args)
    want = sdtw_plain(*args)
    assert LAUNCHES["sdtw"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unsupported device"):
        sdtw(*(a.to("meta") for a in args))
