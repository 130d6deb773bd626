"""Scalar numpy event detection for the ``events-to-text`` dump.

Copies of the five ``sigmap_tpu/signal/events_ref.py`` functions that
``debug_modes.events_to_text`` uses: ``prefix_sums``, ``tstat_centered``,
``detect_peaks``, ``events_from_peaks`` and ``zscore``, with the same
arithmetic (the port imports nothing of the JAX package).  The dump does
not go through the port's device event stages: they sum events by prefix
differences in f32 and z-score in f32, while this reference sums each event
with numpy's pairwise f32 ``sum`` and z-scores in f64, and the printed 6
decimals differ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import EventDetectorConfig

FLT_MAX = np.float32(3.4028235e38)
FLT_MIN = np.float32(1.1754944e-38)


def prefix_sums(signal: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """fp32 prefix sums of x and x^2 with leading zero (event.h:58-68)."""
    x = signal.astype(np.float32)
    ps = np.zeros(len(x) + 1, np.float32)
    pss = np.zeros(len(x) + 1, np.float32)
    np.cumsum(x, dtype=np.float32, out=ps[1:])
    np.cumsum(x * x, dtype=np.float32, out=pss[1:])
    return ps, pss


def tstat_centered(signal: np.ndarray, L: int, w: int) -> np.ndarray:
    """Welch t-statistic of adjacent w-windows from local fp32 window sums
    and a centered two-pass variance; length L+1 (L zeros if L < 2w)."""
    out = np.zeros(L + 1, np.float32)
    if L < 2 * w or w < 2:
        return np.zeros(L, np.float32)
    x = signal.astype(np.float32)
    for i in range(w, L - w + 1):
        a = x[i - w : i]
        b = x[i : i + w]
        m1 = np.float32(a.sum() / w)
        m2 = np.float32(b.sum() / w)
        var = np.float32(((a - m1) ** 2).sum() / w + ((b - m2) ** 2).sum() / w)
        var = max(var, FLT_MIN)
        out[i] = abs(m2 - m1) / np.sqrt(var / np.float32(w))
    return out


@dataclass
class _Det:
    threshold: float
    window_length: int
    masked_to: int = 0
    peak_pos: int = -1
    peak_value: float = FLT_MAX
    valid_peak: bool = False


def detect_peaks(
    tstat1: np.ndarray, tstat2: np.ndarray, L: int, cfg: EventDetectorConfig
) -> list[int]:
    """Dual-window stateful peak caller (event.h:117-182); returns emitted
    peak positions in emission order."""
    peaks: list[int] = []
    short = _Det(cfg.threshold1, cfg.window_length1)
    lng = _Det(cfg.threshold2, cfg.window_length2)
    dets = [(short, tstat1), (lng, tstat2)]
    ph = np.float32(cfg.peak_height)
    for i in range(L):
        for k, (d, ts) in enumerate(dets):
            if d.masked_to >= i:
                continue
            v = np.float32(ts[i])
            if d.peak_pos == -1:
                if v < d.peak_value:
                    d.peak_value = v
                elif v - d.peak_value > ph:
                    d.peak_value = v
                    d.peak_pos = i
            else:
                if v > d.peak_value:
                    d.peak_value = v
                    d.peak_pos = i
                if k == 0 and d.peak_value > d.threshold:
                    lng.masked_to = d.peak_pos + d.window_length
                    lng.peak_pos = -1
                    lng.peak_value = FLT_MAX
                    lng.valid_peak = False
                if d.peak_value - v > ph and d.peak_value > d.threshold:
                    d.valid_peak = True
                if d.valid_peak and (i - d.peak_pos) > d.window_length // 2:
                    peaks.append(d.peak_pos)
                    d.peak_pos = -1
                    d.peak_value = v
                    d.valid_peak = False
    return peaks


def events_from_peaks(
    peaks: list[int], ps: np.ndarray, pss: np.ndarray, L: int,
    signal: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CreateEvents (event.h:200-224): boundaries [0, p_0..p_{n-2}, L].
    With ``signal`` given, per-event stats use direct local sums instead of
    prefix-sum differences.  Returns (starts, means, stdvs)."""
    n = len(peaks)
    if n == 0:
        bounds = [0, L]
    elif n == 1:
        bounds = [0, peaks[0], L]
    else:
        bounds = [0] + list(peaks[: n - 1]) + [L]
    starts = np.array(bounds[:-1], np.int64)
    ends = np.array(bounds[1:], np.int64)
    lengths = (ends - starts).astype(np.float32)
    if signal is not None:
        x = signal.astype(np.float32)
        s = np.array(
            [x[a:b].sum(dtype=np.float32) for a, b in zip(starts, ends)],
            np.float32,
        )
        sq = np.array(
            [(x[a:b] * x[a:b]).sum(dtype=np.float32)
             for a, b in zip(starts, ends)],
            np.float32,
        )
        means = s / lengths
        var = sq / lengths - means * means
    else:
        means = (ps[ends] - ps[starts]) / lengths
        var = (pss[ends] - pss[starts]) / lengths - means * means
    stdvs = np.sqrt(np.maximum(var, 0.0)).astype(np.float32)
    return starts, means.astype(np.float32), stdvs


def zscore(x: np.ndarray) -> np.ndarray:
    """GenerateZscoreNormalizedSignal (sigmap.cc:1131-1155): float64 mean,
    (n-1) variance, output fp32."""
    mean = np.float64(x.astype(np.float64).sum()) / len(x)
    sd = np.sqrt(((x.astype(np.float64) - mean) ** 2).sum() / (len(x) - 1))
    return ((x - np.float32(mean)) / np.float32(sd)).astype(np.float32)
