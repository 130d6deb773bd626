"""Kernels B1 (peak state machine) and B2 (compression keep mask).

CUDA sources: ``sigmap_tpu_torch/csrc/events.cu``.  They replace
``sigmap_tpu/signal/events_pallas.py:_peaks_kernel`` (via
``detect_peaks_pallas``) and ``_compress_kernel`` (via
``compress_keep_pallas``).

Each wrapper runs the plain PyTorch version on a CPU tensor and launches the
kernel on a CUDA tensor; nothing else is accepted.
"""

from __future__ import annotations

import torch

from .._build import check, count_launch, kernels
from ..config import EventDetectorConfig

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


def _rows16(x, pad: int):
    """`x` as contiguous f32 rows that the kernels' 16-byte copies take:
    padded with `pad` zero columns (rows of a length no multiple of 4), or
    copied if it starts off a 16-byte boundary."""
    x = x.to(torch.float32)
    if pad:
        return torch.nn.functional.pad(x, (0, pad))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def detect_peaks(tstat1, tstat2, lengths, cfg: EventDetectorConfig):
    """B1 wrapper: [R, C] f32 t-stats + [R] lengths -> [R, 2C] i32."""
    dev = tstat1.device
    if dev.type == "cpu":
        return detect_peaks_plain(tstat1, tstat2, lengths, cfg)
    if dev.type != "cuda":
        raise ValueError(f"detect_peaks: unsupported device {dev}")
    R, C = tstat1.shape
    if tstat2.shape != (R, C) or lengths.shape != (R,):
        raise ValueError("detect_peaks: shape mismatch")
    # the kernel reads [R, C] and writes [R, 2C] as they are: no transpose.
    # Its copies are 16 bytes each: rows of another length are padded to a
    # multiple of 4 steps (never active: the lengths stop at C), and a view
    # that starts off a 16-byte boundary is copied
    pad = -C % 4
    lens = lengths.to(torch.int32).clamp(max=C).contiguous()
    t1, t2 = _rows16(tstat1, pad), _rows16(tstat2, pad)
    out = torch.empty((R, 2 * (C + pad)), dtype=torch.int32, device=dev)
    lib = kernels()
    err = lib.sig_peaks_launch(
        t1.data_ptr(), t2.data_ptr(), lens.data_ptr(), R, C + pad,
        cfg.window_length1, cfg.window_length2, float(cfg.threshold1),
        float(cfg.threshold2), float(cfg.peak_height), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "peaks")
    count_launch("peaks")
    return out[:, :2 * C].contiguous() if pad else out


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


def compress_keep(norm, n, delta: float):
    """B2 wrapper: [R, E] f32 z-scored means + [R] counts -> [R, E] i32."""
    dev = norm.device
    if dev.type == "cpu":
        return compress_keep_plain(norm, n, delta)
    if dev.type != "cuda":
        raise ValueError(f"compress_keep: unsupported device {dev}")
    R, E = norm.shape
    if n.shape != (R,):
        raise ValueError("compress_keep: shape mismatch")
    # the kernel reads [R, E] and writes [R, E] as they are: no transpose.
    # Its copies are 16 bytes each: rows of another length are padded to a
    # multiple of 4 events (never kept where they count: the mask is cut
    # back to E, and a padded event lies after every real one), and a view
    # that starts off a 16-byte boundary is copied
    pad = -E % 4
    x = _rows16(norm, pad)
    nn = n.to(torch.int32).contiguous()
    keep = torch.empty((R, E + pad), dtype=torch.int32, device=dev)
    lib = kernels()
    err = lib.sig_compress_keep_launch(
        x.data_ptr(), nn.data_ptr(), R, E + pad, float(delta),
        keep.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "compress_keep")
    count_launch("compress_keep")
    return keep[:, :E].contiguous() if pad else keep
