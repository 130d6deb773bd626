"""The batch head, plain: transport quantization, dequantization and the
event features of each chunk row.

Frozen copies of the port's plain PyTorch versions (``signal/events.py``
with the plain B1 and B2 of ``signal/events_kernels.py``, and
``mapping/turbo.py``'s ``stage_batch``, ``quantize`` and ``dequantize``),
importing nothing of the port.  A row's features depend on its own
samples, affine and length alone, so rows are computed without the
program's row blocks.

``precision="bf16"`` is the check's control: the dequantized pA and the
z-scored event means are rounded to bfloat16 where the head computes
them, the head computed a step below the f32 that the configuration
states.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import EventDetectorConfig

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


FLT_MAX = 3.4028234663852886e38  # float32 max, exactly representable


def _det_step(v, i, pp, pv, valid, masked, thr, wl, ph, active):
    """One step of one detector (events.py:_detector_step, event.h:127-179)."""
    act = active & (masked < i)
    in_def = pp == -1
    lower = v < pv
    fire = ~lower & ((v - pv) > ph)
    pp1 = torch.where(fire, i, pp)
    pv1 = torch.where(lower | fire, v, pv)
    upd = v > pv
    pp2 = torch.where(upd, i, pp)
    pv2 = torch.where(upd, v, pv)
    valid2 = valid | (((pv2 - v) > ph) & (pv2 > thr))
    emit = valid2 & ((i - pp2) > (wl // 2))
    new_pp = torch.where(act, torch.where(in_def, pp1,
                                          torch.where(emit, -1, pp2)), pp)
    new_pv = torch.where(act, torch.where(in_def, pv1,
                                          torch.where(emit, v, pv2)), pv)
    new_valid = torch.where(act, torch.where(in_def, valid, valid2 & ~emit),
                            valid)
    emit_pos = torch.where(act & ~in_def & emit, pp2 + 1, 0)
    dominate = act & ~in_def & (pv2 > thr)
    return new_pp, new_pv, new_valid, emit_pos, dominate, pp2


def detect_peaks_plain(tstat1, tstat2, lengths, cfg: EventDetectorConfig):
    """Plain version of B1: a loop over the C steps, vectorised over rows.
    Returns emissions [R, 2C] i32 (position + 1, or 0), interleaved
    (short, long) per step."""
    R, C = tstat1.shape
    dev = tstat1.device
    lengths = lengths.to(torch.int32)
    ph = float(cfg.peak_height)
    th1, th2 = float(cfg.threshold1), float(cfg.threshold2)
    w1, w2 = cfg.window_length1, cfg.window_length2
    m1 = torch.full((R,), -1, dtype=torch.int32, device=dev)
    s = [m1, torch.full((R,), FLT_MAX, dtype=torch.float32, device=dev),
         torch.zeros(R, dtype=torch.bool, device=dev),
         torch.zeros(R, dtype=torch.int32, device=dev)]
    lg = [t.clone() for t in s]
    out = torch.zeros((C, R, 2), dtype=torch.int32, device=dev)
    for i in range(C):
        active = i < lengths
        pp, pv, valid, emit_s, dominate, s_pp2 = _det_step(
            tstat1[:, i], i, s[0], s[1], s[2], s[3], th1, w1, ph, active)
        s = [pp, pv, valid, s[3]]
        l_pp = torch.where(dominate, -1, lg[0])
        l_pv = torch.where(dominate, FLT_MAX, lg[1])
        l_valid = lg[2] & ~dominate
        l_mask = torch.where(dominate, s_pp2 + w1, lg[3])
        pp, pv, valid, emit_l, _, _ = _det_step(
            tstat2[:, i], i, l_pp, l_pv, l_valid, l_mask, th2, w2, ph, active)
        lg = [pp, pv, valid, l_mask]
        out[i, :, 0] = emit_s
        out[i, :, 1] = emit_l
    return out.permute(1, 0, 2).reshape(R, 2 * C)


def compress_keep_plain(norm, n, delta: float):
    """Plain version of B2 (sigmap.cc:1072-1079): keep j == 0 or any value
    whose |difference| from the last kept value exceeds delta, for j < n.
    Returns [R, E] i32."""
    R, E = norm.shape
    n = n.to(torch.int32)
    last = torch.zeros(R, dtype=torch.float32, device=norm.device)
    keep = torch.zeros((R, E), dtype=torch.int32, device=norm.device)
    for j in range(E):
        v = norm[:, j]
        k = (j < n) & ((j == 0) | (torch.abs(v - last) > delta))
        keep[:, j] = k.to(torch.int32)
        last = torch.where(k, v, last)
    return keep


def stage_batch(batch, B, NC, Cs, max_chunks, pin: bool = False):
    """Host half of the transport quantization (turbo.py:440-473): each
    read's first L = min(length, NC * Cs) pA samples as f32 in a row of pa
    [B, NC * Cs] (pinned if ``pin``; past L a row holds whatever the
    buffer held), and per read L, the DAC affine (scale, off) that the
    reference tries first, and n_full.  Rows past the batch's reads have L
    = 0, scale 1, off 0, n_full 0.  Returns (pa tensor, L, scale, off,
    n_full numpy arrays)."""
    pa = torch.empty((B, NC * Cs), dtype=torch.float32, pin_memory=pin)
    rows = pa.numpy()
    L = np.zeros(B, np.int32)
    scale = np.ones(B, np.float32)
    off = np.zeros(B, np.float32)
    n_full = np.zeros(B, np.int32)
    for i, s in enumerate(batch):
        n_full[i] = min(s.length // Cs, max_chunks)
        L[i] = min(s.length, NC * Cs)
        rows[i, :L[i]] = s.pa[:L[i]]
        scale[i] = (np.float32(s.range / s.digitisation) if s.digitisation
                    else 0)
        off[i] = np.float32(s.offset)
    return pa, L, scale, off, n_full


def quantize(pa, L, scale, off):
    """Device half of the transport quantization: pa [B, N] f32 on the
    device and the host arrays of ``stage_batch`` -> (q [B, N] i32 in
    0..65535, qoff [B] f32, qscale [B] f32) on the device, equal to the
    reference's host quantization (turbo.py:440-473) element for element.
    A read keeps its DAC affine if every rint(pa / scale - off) of its
    first L samples lies in 0..65535 and maps back to its pA exactly;
    otherwise its affine spans its min and max.  Which reads keep it, and
    their min and max, come to the host once, where the fallback affine is
    computed with the reference's own scalar arithmetic.  q is 0 past L."""
    dev = pa.device
    inside = (torch.arange(pa.shape[1], device=dev)[None, :]
              < torch.from_numpy(L).to(dev)[:, None])
    s0 = torch.from_numpy(scale).to(dev)[:, None]
    o0 = torch.from_numpy(off).to(dev)[:, None]
    k = torch.where(inside, torch.round(pa / s0 - o0), 0.0)
    fits = ((k.amin(1) >= 0) & (k.amax(1) <= 65535)
            & torch.where(inside, (k + o0) * s0 == pa, True).all(1))
    lo = torch.where(inside, pa, torch.inf).amin(1)
    hi = torch.where(inside, pa, -torch.inf).amax(1)
    fits, lo, hi = (t.cpu().numpy() for t in (fits, lo, hi))
    qoff, qscale = off.copy(), scale.copy()
    for i in np.flatnonzero((L > 0) & ~((scale > 0) & fits)):
        qscale[i] = np.float32(max(hi[i] - lo[i], 1e-6) / 65000.0)
        qoff[i] = np.float32(lo[i] / qscale[i])
    qoff_d, qscale_d = (torch.from_numpy(a).to(dev) for a in (qoff, qscale))
    k = torch.clamp(torch.round(pa / qscale_d[:, None] - qoff_d[:, None]),
                    0, 65535)
    return torch.where(inside, k, 0.0).to(torch.int32), qoff_d, qscale_d


def dequantize(q, qoff, qscale):
    """pa [R, Cs] f32 = (q + qoff) * qscale of head rows, which reproduces
    io.signals.dac_to_pa bit for bit for DAC-derived reads."""
    return (q.to(torch.float32) + qoff[:, None]) * qscale[:, None]



def _bf16(x, precision: str):
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def rows_features(q, qoff, qscale, clen, cfg, max_events: int,
                  max_features: int, compress_delta: float,
                  precision: str = "f32"):
    """Head rows (quantized samples, per-row affine and length) ->
    (feats [R, F] f32, counts [R] i32): the port's ``rows_features`` and
    ``feature_stages`` with the plain B1 and B2."""
    chunks = _bf16(dequantize(q, qoff, qscale), precision)
    lengths = clen
    t1 = batch_tstat(chunks, lengths, cfg.window_length1)
    t2 = batch_tstat(chunks, lengths, cfg.window_length2)
    emits = detect_peaks_plain(t1, t2, lengths, cfg)
    peaks1, n_peaks = compact_nonzero(emits, max_events)
    means, num_events = events_means_batch(
        peaks1 - 1, n_peaks, chunks, lengths, max_events)
    norm = _bf16(zscore_masked(means, num_events), precision)
    keep = compress_keep_plain(norm, num_events, compress_delta)
    return compress_means_batch(norm, keep, max_features)
