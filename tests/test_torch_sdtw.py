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


# --- B5's launch plan and band decomposition (csrc/sdtw.cu) -----------------

import ast  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from sigmap_tpu_torch.ops.sdtw_kernel import (  # noqa: E402
    CLUSTERS, MAX_WARPS, ROWS, make_plan, plan,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import sdtw_adversarial  # noqa: E402

SMEM_LIMIT = 232_448                 # shared memory a CTA may use, bytes
SMS = 132                            # an H100 SXM's SMs (the plan's `sms`)
BENCH_DTW = (1024, 2048, 512)        # bench.py:bench_dtw
DTW_ALIGN = (64, 48_497, 27_062)     # the debug cell's dtw-align pairs
CWT_ALIGN = (64, 20_594, 1_500)      # its cwt-align pairs (Q at most)
PLAN_SHAPES = [BENCH_DTW, DTW_ALIGN, CWT_ALIGN, (1, 10, 1), (1, 1, 200_000),
               (3, 500, 40_000), (8, 100, 5), (132, 3000, 3000),
               (133, 3000, 3000), (64, 20_594, 300), (2, 0, 0), (17, 64, 777)]


def _strips(pl, Q, lanes=32):
    """[start, stop) of every lane's rows, in the kernel's order: pass,
    CTA of the cluster, warp, lane (lanes=1: the first lane's rows of each
    warp, so the starts are those of the warp bands)."""
    out = []
    for p in range(pl.passes):
        for b in range(pl.cluster):
            for w in range(pl.warps):
                for k in range(lanes):
                    a = p * pl.pass_rows + (b * pl.warps + w) * pl.band_rows \
                        + k * pl.rows
                    out.append((a, a + pl.rows))
    return out


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_query_row_once(shape):
    B, T, Q = shape
    pl = plan(B, T, Q, SMS)
    rows = np.zeros(max(Q, 1), np.int64)
    for a, b in _strips(pl, Q):
        rows[a:min(b, Q)] += 1
    assert (rows[:Q] == 1).all()
    # no pass is wholly beyond Q: the last pass holds Q - 1
    assert (pl.passes - 1) * pl.pass_rows < max(Q, 1) <= \
        pl.passes * pl.pass_rows


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_stays_in_the_card_limits(shape):
    B, T, Q = shape
    pl = plan(B, T, Q, SMS)
    assert pl.rows in ROWS and 1 <= pl.warps <= MAX_WARPS
    assert pl.cluster in CLUSTERS and pl.cluster <= 8
    assert pl.smem_bytes <= SMEM_LIMIT
    assert pl.ctas == max(B, 1) * pl.cluster
    assert pl.scratch_bytes == (4 * max(B, 1) * T if pl.passes > 1 else 0)
    if pl.cluster > 1:
        assert pl.ctas <= SMS       # split a pair only within one wave
        # every CTA of the cluster holds rows in the first pass
        assert math.ceil(Q / pl.band_rows / pl.warps) >= pl.cluster


def test_plan_fills_the_card_at_dtw_align():
    """64 pairs on 132 SMs: each pair over a cluster, >= 128 SMs busy."""
    pl = plan(*DTW_ALIGN, SMS)
    assert pl.cluster >= 2 and min(pl.ctas, SMS) >= 128
    # short queries
    assert plan(*CWT_ALIGN, SMS).rows < plan(*BENCH_DTW, SMS).rows
    # forced choices are honoured, and a refused one raises
    assert make_plan(*DTW_ALIGN, 4, 4)[:3] == (4, 32, 4)
    assert make_plan(*DTW_ALIGN, 2, 1, 3)[:4] == (2, 3, 1, 141)
    with pytest.raises(ValueError):
        make_plan(1, 10, 10, 2, 8)   # CTAs without rows


@pytest.mark.parametrize("shape,sms,want", [
    # (rows, warps, cluster, passes)
    (DTW_ALIGN, SMS, (8, 32, 2, 2)),    # no one-pass launch: 8 rows a lane
    (CWT_ALIGN, SMS, (2, 12, 2, 1)),
    (BENCH_DTW, SMS, (4, 4, 1, 1)),     # 2 rows: 64 warps an SM, two waves
    (DTW_ALIGN, 16, (8, 32, 1, 4)),     # fewer SMs than pairs: no cluster
    (CWT_ALIGN, 520, (2, 3, 8, 1)),     # 8 CTAs a pair on 512 SMs
])
def test_plan_rules(shape, sms, want):
    """The largest cluster whose CTAs fit on the SMs at once, then the
    fewest rows a lane that cover the query in one pass in one wave of at
    most 32 warps an SM, else 8."""
    assert plan(*shape, sms)[:4] == want


def banded_sdtw(t, q, starts):
    """sDTW of one pair computed band by band: the bands are the query rows
    [starts[k], starts[k + 1]) (the last ends at len(q)); a band sees only
    the last row of the band above (D(i, start - 1) for every i; for the
    first band the free start, 0) and runs its own anti-diagonal
    wavefront, with D(-1, .) = 1e30 on its diagonal at i = 0."""
    f32 = np.float32
    t, q = np.asarray(t, f32), np.asarray(q, f32)
    tl, ql = len(t), len(q)
    if tl == 0 or ql == 0:
        return f32(BIG), -1
    above = np.zeros(tl, f32)            # D(i, -1): the free start
    bounds = [s for s in starts if s < ql] + [ql]
    for a, b in zip(bounds[:-1], bounds[1:]):
        h = b - a
        jj = np.arange(h)
        prev = np.full(h, BIG, f32)       # anti-diagonal d - 1
        prev2 = np.full(h, BIG, f32)      # anti-diagonal d - 2
        out = np.empty(tl, f32)
        for d in range(tl + h - 1):
            i = d - jj
            valid = (i >= 0) & (i < tl)
            ic = np.clip(i, 0, tl - 1)
            left = np.concatenate([[above[ic[0]]], prev[:-1]])
            diag = np.concatenate([[above[i[0] - 1] if 1 <= i[0] <= tl else BIG],
                                   prev2[:-1]]).astype(f32)
            cost = np.abs(t[ic] - q[a:b]).astype(f32)
            cur = (cost + np.minimum(np.minimum(prev, diag), left)).astype(
                f32)
            cur = np.where(valid, cur, f32(BIG))
            if valid[h - 1]:
                out[i[h - 1]] = cur[h - 1]
            prev2, prev = prev, cur
        above = out
    k = int(np.argmin(above))            # the first minimum in target order
    return above[k], k + 1


def _launch_cases():
    """(launch, arrays) of the plan's own launch at small shapes and of
    chip_smoke's hand-made launches with q_len at band and pass edges."""
    rng = np.random.default_rng(5)
    out = []
    for R, nw, C in ((2, 2, 2), (4, 1, 4), (8, 2, 1)):
        band, prow = 32 * R, C * nw * 32 * R
        qls = [1, band - 1, band, band + 1, 2 * band, prow - 1, prow,
               prow + 1, 2 * prow + 3]
        T, Q = 37, max(qls)
        tl = rng.integers(1, T + 1, len(qls)).astype(np.int32)
        tl[0] = T
        arrays = (rng.normal(0, 1, (len(qls), T)).astype(np.float32), tl,
                  rng.normal(0, 1, (len(qls), Q)).astype(np.float32),
                  np.array(qls, np.int32))
        out.append((make_plan(len(qls), T, Q, R, C, nw), arrays))
    ts, tl, qs, ql = _ragged()
    out.append((plan(len(ts), ts.shape[1], qs.shape[1], SMS),
                (ts, tl, qs, ql)))
    return out


@pytest.mark.parametrize("case", range(4))
def test_band_by_band_sdtw_equals_plain_and_np(case):
    """The boundary rules B5 relies on: each lane's strip of R rows (and so
    each warp band, CTA and pass) sees only the last row of the strip above,
    the free start in the first, D(-1, .) = 1e30 on the diagonal at i = 0
    in the others, and q_len - 1 on a strip's first or last row."""
    launch, (ts, tl, qs, ql) = _launch_cases()[case]
    best, end = _port(ts, tl, qs, ql)
    for b in range(len(ts)):
        t, q = ts[b, : tl[b]], qs[b, : ql[b]]
        starts = [a for a, _ in _strips(launch, qs.shape[1])]
        got = banded_sdtw(t, q, starts)
        assert got == (best[b], end[b]), (b, got, best[b], end[b])
        if len(q) <= 300:
            nb, ne = sdtw_np(t, q)
            assert best[b] == np.float32(nb) and end[b] == ne, b


def test_gpu_cases_are_chip_smokes_adversarial_set():
    """tests/test_torch_gpu.py runs every case of sdtw_adversarial."""
    path = os.path.join(os.path.dirname(__file__), "test_torch_gpu.py")
    tree = ast.parse(open(path).read())
    cases = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "SDTW_CASES")
    assert set(cases) - {"pairs"} == set(sdtw_adversarial())


@pytest.mark.parametrize("name", sorted(sdtw_adversarial()))
def test_sdtw_plain_on_the_adversarial_set(name):
    """sdtw_plain on chip_smoke's B5 set (which the card holds the kernel
    to) equals the band-by-band form at the launch's warp bands, and
    sdtw_np on its non-empty pairs of up to 40,000 cells; the tied pairs
    end at the first of their minima."""
    launch, (ts, tl, qs, ql) = sdtw_adversarial()[name]
    launch = launch or plan(len(ts), ts.shape[1], qs.shape[1], SMS)
    best, end = _port(ts, tl, qs, ql)
    starts = [a for a, _ in _strips(launch, qs.shape[1], lanes=1)]
    for b in range(len(ts)):
        t, q = ts[b, : tl[b]], qs[b, : ql[b]]
        if tl[b] * ql[b] > 200_000:
            continue
        assert banded_sdtw(t, q, starts) == (best[b], end[b]), b
        if 0 < tl[b] * ql[b] <= 40_000:
            nb, ne = sdtw_np(t, q)
            assert best[b] == np.float32(nb) and end[b] == ne, b
    if name == "ties":
        assert list(end) == [1, 96, 1, 8]
