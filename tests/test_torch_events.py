"""Port of the event-detection path (kernels B1/B2's plain versions and the
tensor code around them) vs sigmap_tpu.signal.

B1 and B2 are compared exactly on identical inputs (the t-statistics or
z-scored means computed once by the JAX package and fed to both).  The
whole feature path is compared with a bound: XLA's CPU backend contracts
the variance and z-score accumulations into fused multiply-adds and sums
and prefix-sums rows in its own order, while the port rounds each f32
operation separately (as the TPU does); the measured difference on these
inputs is a few f32 ulps of the z-scored features, and counts match on
every row.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigmap_tpu.config import EventDetectorConfig
from sigmap_tpu.signal import events as jev
from sigmap_tpu.signal.events_pallas import (
    compress_keep_pallas, detect_peaks_pallas,
)
from sigmap_tpu_torch.signal import events as tev
from sigmap_tpu_torch.signal import events_kernels as tk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import compress_adversarial, peaks_adversarial  # noqa: E402

TSTAT_RTOL = 1e-5       # |port - jax| / (|jax| + 1) for the t-statistics
FEAT_ATOL = 1e-5        # features are z-scores of order 1


def _kernels_case(seed=42):
    """tests/test_kernels.py:13 inputs."""
    rng = np.random.default_rng(seed)
    B, C = 6, 1200
    sigs = rng.normal(80, 8, (B, C)).astype(np.float32)
    for b in range(B):
        for s in range(0, C, 9):
            sigs[b, s: s + 9] += rng.normal(0, 6)
    return sigs, np.array([C, C - 100, 500, C, 50, 7], np.int32)


def _events_case(seed=42):
    """tests/test_events.py:146 inputs."""
    rng = np.random.default_rng(seed)
    B, C = 5, 1500
    sigs = rng.normal(85, 10, (B, C)).astype(np.float32)
    for b in range(B):
        for s in range(0, C, 11):
            sigs[b, s: s + 11] += rng.normal(0, 7)
    return sigs, np.array([C, C - 137, 600, 51, 0], np.int32)


CASES = {"kernels": _kernels_case, "events": _events_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_peaks_plain_matches_pallas_and_scan(case):
    sigs, lengths = CASES[case]()
    cfg = EventDetectorConfig()
    t1 = np.asarray(jev.batch_tstat(sigs, lengths, cfg.window_length1))
    t2 = np.asarray(jev.batch_tstat(sigs, lengths, cfg.window_length2))
    scan = np.asarray(
        jev.detect_peaks_batch(t1, t2, jnp.asarray(lengths), cfg))
    pal = np.asarray(detect_peaks_pallas(t1, t2, jnp.asarray(lengths), cfg,
                                         interpret=True))
    port = tk.detect_peaks(torch.from_numpy(t1), torch.from_numpy(t2),
                           torch.from_numpy(lengths), cfg).numpy()
    assert port.shape == scan.shape and port.dtype == np.int32
    np.testing.assert_array_equal(port, scan)
    np.testing.assert_array_equal(port, pal)
    assert port.any(), "inputs produced no peaks"


def test_peaks_plain_matches_scan_on_adversarial_rows():
    """chip_smoke.py's adversarial rows (lengths 0, below two windows and
    full; R off a warp's 32 rows, C off the kernel's 64-step tile and no
    multiple of 4; a short peak masking the long detector across a tile
    boundary) against the JAX package's scan and its Pallas kernel in
    interpret mode, exactly."""
    t1, t2, lengths = peaks_adversarial(0)
    cfg = EventDetectorConfig()
    R, C = t1.shape
    assert R % 32 and C % 64 and C % 4
    assert {0, 5, 11, C} <= set(lengths.tolist())
    scan = np.asarray(
        jev.detect_peaks_batch(t1, t2, jnp.asarray(lengths), cfg))
    pal = np.asarray(detect_peaks_pallas(t1, t2, jnp.asarray(lengths), cfg,
                                         interpret=True))
    port = tk.detect_peaks(torch.from_numpy(t1), torch.from_numpy(t2),
                           torch.from_numpy(lengths), cfg).numpy()
    np.testing.assert_array_equal(port, scan)
    np.testing.assert_array_equal(port, pal)
    assert (port[lengths == 0] == 0).all()
    # row 3: the short detector emits its peak at step 62 (position + 1)
    # in the first tile and the long detector, masked until step 65, emits
    # nothing before step 70
    short, long_ = port[3, 0::2], port[3, 1::2]
    assert 63 in short[60:70] and not long_[58:70].any()
    # the same row with the short peak flattened: the long detector fires
    flat = t1.copy()
    flat[3, 60:64] = 0.25
    free = tk.detect_peaks(torch.from_numpy(flat), torch.from_numpy(t2),
                           torch.from_numpy(lengths), cfg).numpy()
    assert free[3, 1::2][58:70].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_keep_plain_matches_pallas(case):
    sigs, lengths = CASES[case]()
    cfg = EventDetectorConfig()
    t1 = jev.batch_tstat(sigs, lengths, cfg.window_length1)
    t2 = jev.batch_tstat(sigs, lengths, cfg.window_length2)
    emits = jev.detect_peaks_batch(t1, t2, jnp.asarray(lengths), cfg)
    peaks1, n_peaks = jev.compact_nonzero(emits, 1024)
    means, num_events = jev.events_means_batch(peaks1 - 1, n_peaks, sigs,
                                               jnp.asarray(lengths), 1024)
    norm = np.asarray(jev.zscore_masked(means, num_events))
    ne = np.asarray(num_events)
    pal = np.asarray(compress_keep_pallas(norm, ne, 0.1, interpret=True))
    port = tk.compress_keep(torch.from_numpy(norm), torch.from_numpy(ne),
                            0.1).numpy()
    np.testing.assert_array_equal(port, pal)
    assert port.sum() > len(ne)


def test_compress_keep_plain_matches_pallas_on_adversarial_rows():
    """chip_smoke.py's B2 rows (n = 0, 1, E; E off the kernel's 64-event
    tile and no multiple of 4, R off a warp's 32 rows; equal runs; steps of
    exactly delta and one ulp either side; negative zero; a kept value that
    lasts across a tile boundary) against the JAX package's Pallas kernel
    in interpret mode, exactly; on the card test_torch_gpu.py holds the
    kernel to the plain version on the same rows."""
    norm, n, delta = compress_adversarial(0)
    R, E = norm.shape
    assert R % 32 and E % 64 and E % 4
    pal = np.asarray(compress_keep_pallas(norm, n, delta, interpret=True))
    port = tk.compress_keep(torch.from_numpy(norm), torch.from_numpy(n),
                            delta).numpy()
    np.testing.assert_array_equal(port, pal)
    assert port[0].sum() == 0 and port[1].tolist() == [1] + [0] * (E - 1)
    assert port[8].all()
    # row 4: delta and one ulp below it, up and down from the last kept
    # value, are not kept; one ulp above it is, down and then up
    assert port[4, :9].tolist() == [1, 0, 0, 0, 0, 1, 1, 1, 0]
    # rows 5, 6: negative zero as the first kept value and against it
    assert port[5, :5].tolist() == [1, 0, 0, 0, 1]
    assert port[6, :5].tolist() == [1, 0, 0, 1, 1]
    # row 7: 0.0 kept at event 63 decides events 64-73 (tile 1)
    assert port[7, 63:75].tolist() == [1] + [0] * 9 + [1, 1]


def _tstat_f64(sigs, lengths, w):
    """The two-window t-statistic of batch_tstat in float64 (numpy): the
    yardstick a mismatch between the port and the JAX package is read
    against."""
    B, C = sigs.shape
    i = np.arange(C)[None, :]
    L = lengths.astype(np.int64)[:, None]
    x = np.where(i < L, sigs, 0.0).astype(np.float64)
    xp = np.pad(x, ((0, 0), (w, w)))
    win = [xp[:, w + off: w + off + C] for off in range(-w, w)]
    m1, m2 = sum(win[:w]) / w, sum(win[w:]) / w
    v = (sum((a - m1) ** 2 for a in win[:w])
         + sum((a - m2) ** 2 for a in win[w:])) / w
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.abs(m2 - m1) / np.sqrt(np.maximum(v, tev.FLT_MIN) / w)
    valid = (i >= w) & (i <= L - w) & (L >= 2 * w)
    return np.where(valid, t, 0.0)


def _tstat_mismatch(got, want, sigs, lengths, w):
    """None if the port's t-statistics `got` are within TSTAT_RTOL of the
    JAX package's `want` (assert_allclose's test), else what differs: how
    many, the first (row, column) with both values, the float64 value and
    the zero mask there, and how far each side lies from float64 over the
    whole array, which names the side that moved."""
    close = np.isclose(got, want, rtol=TSTAT_RTOL, atol=TSTAT_RTOL,
                       equal_nan=True)
    if close.all():
        return None
    ref = _tstat_f64(sigs, lengths, w)
    r, c = (int(k) for k in np.argwhere(~close)[0])
    valid = w <= c <= lengths[r] - w and lengths[r] >= 2 * w

    def off(a):
        return float(np.max(np.abs(a - ref) / (np.abs(ref) + 1)))

    return (f"{int((~close).sum())} of {got.size} t-statistics differ "
            f"beyond TSTAT_RTOL; the first at (row {r}, column {c}): port "
            f"{got[r, c]!r}, JAX {want[r, c]!r}, float64 {ref[r, c]!r}; "
            f"zero there: port {bool(got[r, c] == 0)}, JAX "
            f"{bool(want[r, c] == 0)}, inside the valid mask {valid}; "
            f"largest |t - float64| / (|float64| + 1): port {off(got):.3g}, "
            f"JAX {off(want):.3g}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("w", [3, 6])
def test_batch_tstat_matches(case, w):
    sigs, lengths = CASES[case]()
    want = np.asarray(jev.batch_tstat(sigs, lengths, w))
    got = tev.batch_tstat(torch.from_numpy(sigs), torch.from_numpy(lengths),
                          w).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    # assert_allclose(got, want, rtol=atol=TSTAT_RTOL), with a message that
    # names the first mismatch and the side that moved
    msg = _tstat_mismatch(got, want, sigs, lengths, w)
    assert msg is None, msg


def test_tstat_mismatch_names_itself():
    """The t-statistic test's failure message: the mismatch count, the
    first (row, column), both values, float64 there, the zero mask, and
    which side lies off float64; silent within TSTAT_RTOL."""
    sigs, lengths = CASES["events"]()
    want = tev.batch_tstat(torch.from_numpy(sigs), torch.from_numpy(lengths),
                           3).numpy()
    ref = _tstat_f64(sigs, lengths, 3)
    assert np.all(np.abs(want - ref) <= TSTAT_RTOL * (np.abs(ref) + 1))
    assert _tstat_mismatch(want, want.copy(), sigs, lengths, 3) is None
    got = want.copy()
    got[1, 40] *= 1 + 3e-4
    got[2, 100] *= 1 + 3e-4
    msg = _tstat_mismatch(got, want, sigs, lengths, 3)
    assert msg.startswith("2 of 7500 t-statistics differ")
    assert "(row 1, column 40)" in msg and "inside the valid mask True" in msg
    assert f"port {got[1, 40]!r}, JAX {want[1, 40]!r}" in msg
    port_off, jax_off = (float(x) for x in msg.rsplit(": port ", 1)[1]
                         .split(", JAX "))
    assert port_off > 1e-4 > jax_off


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_generate_features_matches(case):
    sigs, lengths = CASES[case]()
    fj, cj = jev.batch_generate_features(sigs, lengths)
    fp, cp = tev.batch_generate_features(torch.from_numpy(sigs),
                                         torch.from_numpy(lengths))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=FEAT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_features_match_exact_engine_events(case):
    """The exact engine's features are batch_generate_features'."""
    sigs, lengths = CASES[case]()
    fj, _stdv, cj, _nev = jev.batch_generate_events(sigs, lengths)
    fp, cp = tev.batch_generate_features(torch.from_numpy(sigs),
                                         torch.from_numpy(lengths))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=FEAT_ATOL,
                               rtol=0)


def test_compact_nonzero_matches():
    rng = np.random.default_rng(1)
    v = np.where(rng.random((7, 300)) < 0.1,
                 rng.integers(1, 999, (7, 300)), 0).astype(np.int32)
    for cap in (8, 64, 400):
        pj, nj = jev.compact_nonzero(jnp.asarray(v), cap)
        pp, npp = tev.compact_nonzero(torch.from_numpy(v), cap)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(npp.numpy(), np.asarray(nj))
