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

``plan(B, T, Q, sms)`` chooses the kernel's launch from the shapes and the
card's SM count (pure Python, tested on the CPU): query rows a lane, warps
a CTA and CTAs a pair (a thread block cluster), passes over the query and
the scratch they need.  It splits a pair over the CTAs of a cluster while
the batch has fewer pairs than SMs, and takes fewer rows a lane where the
query is short, so that every SM has rows to work on.
``debug_modes.batch_bounds`` counts its scratch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._build import check, count_launch, kernels

BIG = 1.0e30

# csrc/sdtw.cu's instantiations and the card's limits.
ROWS = (2, 4, 8)             # query rows a lane (template R)
MAX_WARPS = 32               # warps a CTA (1024 threads)
CLUSTERS = (1, 2, 4, 8)      # CTAs a pair; 8 is the portable maximum
CHUNK = 32                   # csrc/sdtw.cu: steps between two barriers
WARPS_PER_SM = 32            # at __launch_bounds__(1024), <= 64 registers


class Plan(NamedTuple):
    """B5's launch: `rows` query rows a lane, `warps` warps a CTA (one band
    of 32 * rows rows each), `cluster` CTAs a pair; `passes` over the
    query, `ctas` in all, `scratch_bytes` of the [B, T] boundary row (0 with
    one pass), `smem_bytes` a CTA (a band's ring of 4 * CHUNK floats and
    target window of 2 * CHUNK)."""
    rows: int
    warps: int
    cluster: int
    passes: int
    ctas: int
    scratch_bytes: int
    smem_bytes: int

    @property
    def band_rows(self) -> int:
        return 32 * self.rows

    @property
    def pass_rows(self) -> int:
        return self.cluster * self.warps * self.band_rows


def make_plan(B: int, T: int, Q: int, rows: int, cluster: int,
              warps: int | None = None) -> Plan:
    """The launch of `rows` rows a lane and `cluster` CTAs a pair, with
    `warps` warps a CTA or as many as the query needs, up to 32.  Raises
    ValueError where a CTA of the cluster would hold no row."""
    B, T, Q = max(1, B), max(0, T), max(1, Q)
    band = 32 * rows
    nw = warps or min(MAX_WARPS, math.ceil(Q / (cluster * band)))
    if math.ceil(Q / (nw * band)) < cluster:
        raise ValueError(f"sdtw: a CTA without rows at B={B} T={T} Q={Q} "
                         f"rows={rows} cluster={cluster} warps={nw}")
    passes = math.ceil(Q / (cluster * nw * band))
    return Plan(rows, nw, cluster, passes, B * cluster,
                4 * B * T if passes > 1 else 0, nw * 6 * CHUNK * 4)


def plan(B: int, T: int, Q: int, sms: int) -> Plan:
    """B5's launch for B pairs of targets up to T and queries up to Q on a
    card of `sms` SMs, by two rules.  CTAs a pair: the largest cluster
    whose B * cluster CTAs fit on the SMs at once and each hold rows, so
    that a batch of fewer pairs than SMs still fills the card.  Rows a lane:
    the fewest that cover the query in one pass while no SM is asked for
    more than 32 warps (one wave), so that short queries spread over more
    lanes; else 8, the fewest passes."""
    for C in reversed(CLUSTERS):
        if C > 1 and max(1, B) * C > sms:
            continue
        fits = []
        for R in ROWS:
            try:
                fits.append(make_plan(B, T, Q, R, C))
            except ValueError:
                pass
        if fits:
            waves = math.ceil(max(1, B) * C / sms)
            return next((p for p in fits if p.passes == 1
                         and waves * p.warps <= WARPS_PER_SM), fits[-1])
    raise AssertionError("a cluster of 1 CTA always holds rows")


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


def sm_count(device) -> int:
    """The SMs of a CUDA device (``plan``'s `sms`)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def sdtw(targets, t_len, queries, q_len, launch: Plan | None = None):
    """B5 wrapper: batched subsequence DTW -> (best [B] f32, end [B] i32),
    launched as ``plan`` says for this card, or as ``launch`` (a
    ``make_plan``).  A launch the card refuses raises."""
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
    pl = launch or plan(B, T, Q, sm_count(dev))
    col = (torch.empty((B, T), dtype=torch.float32, device=dev)
           if Q > pl.pass_rows else None)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    end = torch.empty(B, dtype=torch.int32, device=dev)
    err = kernels().sig_sdtw_launch(
        targets.data_ptr(), t_len.data_ptr(), queries.data_ptr(),
        q_len.data_ptr(), B, T, Q, pl.rows, pl.warps, pl.cluster,
        col.data_ptr() if col is not None else None, best.data_ptr(),
        end.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "sdtw")
    count_launch("sdtw")
    return best, end
