"""Batched event detection: raw chunks -> compressed feature signals.

Counterpart of ``sigmap_tpu/signal/events.py`` (``batch_tstat``,
``compact_nonzero``, ``events_means_batch``, ``zscore_masked``,
``compress_means_batch``, ``batch_generate_features``): plain tensor code around the two kernels of
``events_kernels.py``.  ``feature_stages`` keeps every intermediate, so a
check of the kernels can take their inputs from the main path itself.
Every tensor stays on the device of its input.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EventDetectorConfig
from .events_kernels import compress_keep, detect_peaks

FLT_MIN = float(np.float32(1.1754944e-38))


def _row_sum(x):
    """Row sums [B, 1] of f32 ``x``, added in f64 and rounded once to f32,
    so that a GPU, which adds in another order than the CPU, gives the same
    bits: f64 sums of pA samples and of event means (f32 in (30, 200)) are
    exact in any order, and a sum of their squared deviations is off by
    some 2^-19 of an f32 step at most, which the rounding hides."""
    return x.to(torch.float64).sum(dim=1, keepdim=True).to(torch.float32)


def batch_tstat(chunks, lengths, w: int):
    """Two-window Welch t-statistic [B, C] over centered local windows
    (events.py:45-93, including its documented divergence from the C++
    prefix-sum form: window sums are taken locally by shifted adds and the
    variance in two passes).  Positions outside [w, L-w], and reads with
    L < 2w, are 0."""
    B, C = chunks.shape
    dev = chunks.device
    i = torch.arange(C, device=dev)[None, :]
    L = lengths.to(torch.int64)[:, None]
    x = torch.where(i < L, chunks, 0.0).to(torch.float32)
    xp = F.pad(x, (w, w))                    # index i + w == x[i]
    inv_w = float(np.float32(1.0 / w))

    def shifted(off):
        return xp[:, w + off: w + off + C]

    def wmean(lo):
        s = torch.zeros((B, C), dtype=torch.float32, device=dev)
        for d in range(w):
            s = s + shifted(lo + d)
        return s * inv_w

    def wvar(lo, mean):
        s = torch.zeros((B, C), dtype=torch.float32, device=dev)
        for d in range(w):
            dev_ = shifted(lo + d) - mean
            s = s + dev_ * dev_
        return s * inv_w

    mean1 = wmean(-w)        # window [i-w, i)
    mean2 = wmean(0)         # window [i, i+w)
    comb = torch.clamp(wvar(-w, mean1) + wvar(0, mean2), min=FLT_MIN)
    t = torch.abs(mean2 - mean1) / torch.sqrt(comb * inv_w)
    valid = (i >= w) & (i <= L - w) & (L >= 2 * w)
    return torch.where(valid, t, 0.0)


def compact_nonzero(values, cap: int):
    """[B, N] (0 = empty) -> ([B, cap] nonzeros packed in order, counts)."""
    B, N = values.shape
    mask = values > 0
    counts = torch.clamp(mask.sum(dim=1), max=cap).to(torch.int32)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    dest = torch.where(mask & (pos < cap), pos, cap).to(torch.int64)
    out = torch.zeros((B, cap + 1), dtype=values.dtype, device=values.device)
    out.scatter_(1, dest, torch.where(mask, values, 0))
    return out[:, :cap], counts


def events_means_batch(peaks, n_peaks, chunks, lengths, max_events: int):
    """CreateEvents means (event.h:200-224, events.py:347-380): boundaries
    [0, p_0 .. p_{n-2}, L]; means from one chunk-centered prefix sum."""
    B, C = chunks.shape
    dev = chunks.device
    E = max_events
    n = n_peaks.to(torch.int64)
    num_events = torch.where(n == 0, 1, torch.where(n == 1, 2, n))
    j = torch.arange(E, device=dev)[None, :]
    L = lengths.to(torch.int64)[:, None]
    Q = torch.where(j < n[:, None], peaks[:, :E].to(torch.int64), L)
    prev = torch.gather(Q, 1, torch.clamp(j - 1, min=0).expand(B, E))
    start = torch.where(j == 0, 0, prev)
    end = torch.where(j == num_events[:, None] - 1, L, Q)
    valid = j < num_events[:, None]
    start = torch.minimum(torch.clamp(start, min=0), L)
    end = torch.maximum(end, start + 1)

    t = torch.arange(C, device=dev)[None, :]
    in_len = t < L
    x = torch.where(in_len, chunks, 0.0).to(torch.float32)
    nf = torch.clamp(L.to(torch.float32), min=1.0)
    cmean = _row_sum(x) / nf
    xc = torch.where(in_len, x - cmean, 0.0)
    # each prefix added in f64 and rounded once, as _row_sum
    ps = F.pad(torch.cumsum(xc.to(torch.float64), dim=1)
               .to(torch.float32), (1, 0))
    # padding events (j >= num_events) can point one past ps; they are
    # masked below, so their gather index is only kept in range
    seg = (torch.gather(ps, 1, torch.clamp(end, max=C))
           - torch.gather(ps, 1, start))
    length = (end - start).to(torch.float32)
    means = seg / length + cmean
    return torch.where(valid, means, 0.0), num_events.to(torch.int32)


def zscore_masked(x, n):
    """Masked z-score along axis 1: population mean, (n-1) variance."""
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < n[:, None]
    nf = n.to(torch.float32)[:, None]
    mean = _row_sum(torch.where(valid, x, 0.0)) / nf
    d = torch.where(valid, x - mean, 0.0)
    sd = torch.sqrt(_row_sum(d * d) / (nf - 1.0))
    return torch.where(valid, (x - mean) / sd, 0.0)


def compress_means_batch(norm, keep, max_features: int):
    """Pack kept z-scored means to the front -> ([B, F] f32, counts [B])."""
    B, E = norm.shape
    F_ = max_features
    counts = torch.clamp(keep.sum(dim=1), max=F_).to(torch.int32)
    k = keep > 0
    pos = torch.cumsum(k.to(torch.int32), dim=1) - 1
    dest = torch.where(k & (pos < F_), pos, F_).to(torch.int64)
    out = torch.zeros((B, F_ + 1), dtype=torch.float32, device=norm.device)
    out.scatter_(1, dest, torch.where(k, norm, 0.0))
    return out[:, :F_], counts


class FeatureStages(NamedTuple):
    """Every stage of ``batch_generate_features``, kernel inputs included."""

    t1: torch.Tensor          # [B, C] f32 short-window t-stat (B1 input)
    t2: torch.Tensor          # [B, C] f32 long-window t-stat (B1 input)
    emits: torch.Tensor       # [B, 2C] i32 peak emissions (B1 output)
    norm: torch.Tensor        # [B, E] f32 z-scored event means (B2 input)
    num_events: torch.Tensor  # [B] i32 (B2 input)
    keep: torch.Tensor        # [B, E] i32 keep mask (B2 output)
    feats: torch.Tensor       # [B, F] f32
    counts: torch.Tensor      # [B] i32


def feature_stages(chunks, lengths,
                   cfg: EventDetectorConfig = EventDetectorConfig(),
                   max_events: int = 1024, max_features: int = 1024,
                   compress_delta: float = 0.1) -> FeatureStages:
    """[B, C] raw pA chunks + [B] lengths -> all stages: t-stats, peaks
    (B1), event means, z-score, delta compression (B2), features."""
    t1 = batch_tstat(chunks, lengths, cfg.window_length1)
    t2 = batch_tstat(chunks, lengths, cfg.window_length2)
    emits = detect_peaks(t1, t2, lengths, cfg)
    peaks1, n_peaks = compact_nonzero(emits, max_events)
    means, num_events = events_means_batch(
        peaks1 - 1, n_peaks, chunks, lengths, max_events
    )
    norm = zscore_masked(means, num_events)
    keep = compress_keep(norm, num_events, compress_delta)
    feats, counts = compress_means_batch(norm, keep, max_features)
    return FeatureStages(t1, t2, emits, norm, num_events, keep, feats, counts)


def batch_generate_features(chunks, lengths,
                            cfg: EventDetectorConfig = EventDetectorConfig(),
                            max_events: int = 1024, max_features: int = 1024,
                            compress_delta: float = 0.1):
    """[B, C] raw pA chunks + [B] lengths -> (features [B, F] f32,
    feature counts [B] i32).

    Also the exact engine's features: the Mapper uses only the features
    and counts of ``batch_generate_events`` (events.py:309-344), whose
    ``events_from_peaks_batch`` means are ``events_means_batch``'s and
    whose ``compress_features_batch`` kept set is B2's keep mask.  Its
    feature stdvs are left out: nothing in the port consumes them."""
    st = feature_stages(chunks, lengths, cfg, max_events, max_features,
                        compress_delta)
    return st.feats, st.counts

