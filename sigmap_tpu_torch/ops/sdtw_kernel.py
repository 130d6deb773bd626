"""Kernel B5: batched subsequence DTW.

CUDA source: ``sigmap_tpu_torch/csrc/sdtw.cu``; it replaces
``sigmap_tpu/ops/sdtw_kernel.py:_kernel`` (via ``sdtw_pallas`` /
``_sdtw_jit``).  ``sdtw`` keeps ``sdtw_pallas``'s layouts: targets [B, T]
f32, t_len [B] i32, queries [B, Q] f32, q_len [B] i32 -> (best [B] f32,
end [B] i32, 1-based; 1e30 and -1 where no last-column cell is valid).  The
wrapper runs ``sdtw_plain`` on a CPU tensor and launches the kernel on a
CUDA tensor.

Both compute the exact sequential recurrence of ``sigmap_tpu/ops/sdtw.py:
sdtw_np`` (one f32 rounding per cell: the cost plus the minimum of three
predecessors), so they equal ``sdtw_np`` and ``sdtw_pallas`` bit for bit.
The port has no counterpart of ``sdtw_scan`` / ``sdtw_batch``: their
prefix-sum form exists to vectorise one DTW row on the TPU and is ~1e-5 off
the exact recurrence.  ``sdtw`` takes ``sdtw_batch``'s role, with the same
arguments.
"""

from __future__ import annotations

import torch

from .._build import LAUNCHES, check, kernels

BIG = 1.0e30
ROWS_PER_THREAD = 16       # csrc/sdtw.cu: R
MAX_LG = 9                 # at most 512 threads per pair


def sdtw_plain(targets, t_len, queries, q_len):
    """Plain version of B5: the anti-diagonal recurrence, one step per
    diagonal d = i + j (T + Q - 1 steps), vectorised over pairs and query
    rows: cur[j] = |t[d-j] - q[j]| + min(prev[j], prev[j-1], prev2[j-1]),
    boundary column 0 (free start), cells with d-j outside [0, t_len) 1e30."""
    B, T = targets.shape
    Q = queries.shape[1]
    dev = targets.device
    t = targets.to(torch.float32)
    q = queries.to(torch.float32)
    tl = t_len.to(torch.int64)[:, None]
    last = (q_len.to(torch.int64) - 1)[:, None]
    has_last = last >= 0
    last_c = torch.clamp(last, min=0)
    # rev[:, Q + T - 1 - d + j] == target[d - j] for every diagonal d
    rev = torch.nn.functional.pad(torch.flip(t, dims=[1]), (Q, Q))
    j = torch.arange(Q, device=dev)[None, :]
    big = torch.full((B, Q), BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    prev, prev2 = big, big
    best = torch.full((B, 1), BIG, dtype=torch.float32, device=dev)
    end = torch.full((B, 1), -1, dtype=torch.int64, device=dev)
    for d in range(T + Q - 1):
        off = Q + T - 1 - d
        cost = torch.abs(rev[:, off: off + Q] - q)
        sh1 = torch.cat([zero, prev[:, :-1]], dim=1)      # prev[j-1]
        sh2 = torch.cat([zero, prev2[:, :-1]], dim=1)     # prev2[j-1]
        cur = cost + torch.minimum(torch.minimum(prev, sh1), sh2)
        i = d - j
        valid = (i >= 0) & (i < tl)
        cur = torch.where(valid, cur, BIG)
        val = torch.gather(cur, 1, last_c)
        seen = has_last & (d - last >= 0) & (d - last < tl)
        better = seen & (val < best)
        best = torch.where(better, val, best)
        end = torch.where(better, d - last + 1, end)
        prev2, prev = prev, cur
    return best[:, 0], end[:, 0].to(torch.int32)


def sdtw(targets, t_len, queries, q_len):
    """B5 wrapper: batched subsequence DTW -> (best [B] f32, end [B] i32)."""
    dev = targets.device
    if dev.type == "cpu":
        return sdtw_plain(targets, t_len, queries, q_len)
    if dev.type != "cuda":
        raise ValueError(f"sdtw: unsupported device {dev}")
    if targets.dim() != 2 or queries.dim() != 2:
        raise ValueError("sdtw: targets and queries must be 2-D")
    B, T = targets.shape
    Q = queries.shape[1]
    if queries.shape[0] != B or t_len.shape != (B,) or q_len.shape != (B,):
        raise ValueError("sdtw: shape mismatch")
    for name, x, dt in (("targets", targets, torch.float32),
                        ("t_len", t_len, torch.int32),
                        ("queries", queries, torch.float32),
                        ("q_len", q_len, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"sdtw: {name} must be a contiguous {dt} "
                             f"tensor on {dev}")
    lg = 5                       # one warp at least
    while lg < MAX_LG and (ROWS_PER_THREAD << lg) < Q:
        lg += 1
    col = (torch.empty((B, 2, T), dtype=torch.float32, device=dev)
           if Q > (ROWS_PER_THREAD << lg) else None)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    end = torch.empty(B, dtype=torch.int32, device=dev)
    err = kernels().sig_sdtw_launch(
        targets.data_ptr(), t_len.data_ptr(), queries.data_ptr(),
        q_len.data_ptr(), B, T, Q, lg,
        col.data_ptr() if col is not None else None, best.data_ptr(),
        end.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "sdtw")
    LAUNCHES["sdtw"] += 1
    return best, end
