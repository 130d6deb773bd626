"""Kernel B4: fused ring-band chaining + chain selection + carry-out.

CUDA source: ``sigmap_tpu_torch/csrc/chain_fused.cu``; it replaces
``sigmap_tpu/ops/chain_fused.py:_kernel`` (via ``chain_fused``).  The
wrapper runs the plain version on a CPU tensor and launches the kernel on a
CUDA tensor.  One launch covers every read: the reference's fixed-grid
chunking (``FIXED_G``) has no counterpart.  A block holds a read's ring in
shared memory (32 B a slot) beside its anchor rows (16 B a row): the whole
read when it fits a block's ``SMEM_LIMIT`` bytes, else windows of rows
streamed through two buffers, with a per-read scratch in device memory for
the selection passes.  So any A is taken; on a CUDA tensor only a ring that
does not fit beside a window of kb rows is refused (``check_fits``: more than
``max_ring(kb)`` slots, some 7,200).  The plain version takes any size.

Layouts are the reference's: anchors [A, B] (rows 0..CARRY-1 carried,
then qpos-major seed slots), carried chain state [CARRY, B], outputs
sum_f [8, B] f32 (s1, s2, sumd1, s3, then zeros), sum_i [8, B] i32 (g1,
t_start, t_end, q_start, q_end, n1, then zeros) and the carry-out ring as 8
[ring, B] arrays (t, q, g, score, start_t, start_q, n, sumd).
"""

from __future__ import annotations

import torch

from .._build import check, count_launch, kernels
from ..config import ChainingConfig

NEG = -1.0e30
SMEM_LIMIT = 232_448   # shared memory a block can use on an H100 (227 KB)
SM_SMEM = 233_472      # shared memory of one H100 SM (228 KB)
_BLOCK_RESERVED = 1024  # of an SM's shared memory, reserved for each block
_FIXED_SMEM = 1696     # the kernel's row, candidate and reduction buffers


def shared_memory_bytes(A: int, CARRY: int, ring: int, kb: int,
                        window_rows: int = 0) -> int:
    """Dynamic shared memory the kernel's block (one read) needs: the twin
    of ``smem_bytes`` in the CUDA source (``sig_chain_fused_smem``).  The
    ring's two 16-byte arrays and the fixed buffers, then either the whole
    read (``window_rows`` 0: four anchor fields a row and one mask a kb-row
    block) or two windows of ``window_rows`` rows and the masks of one,
    whatever A."""
    if window_rows == 0:
        return 32 * ring + 16 * A + 4 * ((A - CARRY) // kb + 1) + _FIXED_SMEM
    return 32 * ring + 32 * window_rows + 4 * (window_rows // kb + 1) \
        + _FIXED_SMEM


def largest_window(ring: int, kb: int) -> int:
    """The most rows (a multiple of kb) a window can hold beside a ring of
    ``ring`` slots; 0 if not even kb rows fit."""
    room = SMEM_LIMIT - 32 * ring - 4 - _FIXED_SMEM
    return max(0, room // (32 * kb + 4)) * kb


def default_window(ring: int, kb: int, blocks_per_sm: int = 3) -> int:
    """The window a read that does not fit whole gets: the most rows (a
    multiple of kb) with which ``blocks_per_sm`` blocks share an SM, as the
    whole reads of the operating point do; the largest window that fits
    when not even kb rows leave room for that many blocks."""
    room = SM_SMEM // blocks_per_sm - _BLOCK_RESERVED - 32 * ring - 4 \
        - _FIXED_SMEM
    rows = max(0, room // (32 * kb + 4)) * kb
    return rows if rows else max(largest_window(ring, kb), kb)


def max_ring(kb: int) -> int:
    """The largest ring that fits beside the smallest window (kb rows)."""
    return (SMEM_LIMIT - _FIXED_SMEM - 32 * kb - 4 * 2) // 32


def check_fits(A: int, CARRY: int, ring: int, kb: int,
               window_rows: int | None = None) -> int:
    """The window the kernel takes a read of ``A`` anchor rows (``CARRY`` of
    them carried) in, beside a ring of ``ring`` slots: 0 for the whole read
    at once, which every read that fits gets unless ``window_rows`` is given,
    else ``window_rows`` or ``default_window``.  Raises ValueError if that
    does not fit a block's shared memory."""
    if window_rows is None:
        if shared_memory_bytes(A, CARRY, ring, kb) <= SMEM_LIMIT:
            return 0
        window_rows = default_window(ring, kb)
    elif window_rows < kb or window_rows % kb:
        raise ValueError(f"chain_fused: window_rows={window_rows} must be a "
                         f"positive multiple of kb={kb}")
    need = shared_memory_bytes(A, CARRY, ring, kb, window_rows)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"chain_fused: a ring of {ring} slots and windows of "
            f"{window_rows} rows need {need} bytes of shared memory "
            f"on the GPU, a block has {SMEM_LIMIT}: at kb={kb} at most "
            f"{max_ring(kb)} ring slots fit beside the smallest window")
    return window_rows


def _push(ring, cur, vals, v, RING: int):
    """Push the valid rows of a block into the ring in row order (a later
    push overwrites an earlier one that lands on the same slot)."""
    vi = v.to(torch.int64)
    rank = torch.cumsum(vi, dim=0) - vi                       # [k, B]
    nval = vi.sum(dim=0)
    keep = v & (rank >= (nval - RING)[None, :])
    slot = (cur[None, :] + rank) % RING
    bcol = torch.arange(v.shape[1], device=v.device)[None, :].expand_as(v)
    si, bi = slot[keep], bcol[keep]
    for r, x in zip(ring, vals):
        r[si, bi] = x[keep]
    return cur + nval


def _best(best, vals):
    """Strict '>' online argmax over a block's rows: the first row with the
    block maximum wins if it beats the running best."""
    s = vals[0]
    k = s.shape[0]
    m = s.amax(dim=0)
    rio = torch.arange(k, device=s.device)[:, None]
    first = torch.where(s == m[None, :], rio, k).amin(dim=0)
    take = m > best[0]
    return tuple(torch.where(take, torch.gather(x, 0, first[None, :])[0], b)
                 for x, b in zip(vals, best))


def chain_fused_plain(a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n,
                      c_sumd, radius: float, dim: int = 6, ring: int = 64,
                      cfg: ChainingConfig = ChainingConfig(), kb: int = 1):
    """Plain version of B4: a loop over KB-row blocks, vectorised over
    reads and ring slots."""
    A, B = a_t.shape
    CARRY = c_score.shape[0]
    RING = ring
    dev = a_t.device
    f32, i32 = torch.float32, torch.int32

    def full(v, dt):
        return torch.full((RING, B), v, dtype=dt, device=dev)

    # ring fields: score, t, q, g, start_t, start_q, n, sumd
    rg = [full(NEG, f32), full(-(1 << 30), i32), full(0, i32), full(-2, i32),
          full(0, i32), full(0, i32), full(0, i32), full(0.0, f32)]
    cur = torch.zeros(B, dtype=torch.int64, device=dev)

    def row1(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    # best: s1, g1, t_end, q_end, start_t, start_q, n, sumd
    best = (row1(NEG, f32), row1(-1, i32), row1(0, i32), row1(0, i32),
            row1(0, i32), row1(0, i32), row1(0, i32), row1(0.0, f32))
    scores = torch.empty((A, B), dtype=f32, device=dev)
    stt_s = torch.empty((A, B), dtype=i32, device=dev)

    # ---- carried rows ----------------------------------------------------
    t, q, g = a_t[:CARRY], a_q[:CARRY], a_g[:CARRY]
    v = g >= 0
    s = torch.where(v, c_score, NEG)
    scores[:CARRY] = s
    stt_s[:CARRY] = c_stt
    vals = (s, g, t, q, c_stt, c_stq, c_n, c_sumd)
    best = _best(best, vals)
    cur = _push(rg, cur, (s, t, q, g, c_stt, c_stq, c_n, c_sumd), v, RING)

    # ---- DP blocks -------------------------------------------------------
    kio = torch.arange(RING, device=dev)[None, :, None]
    # divide by a tensor: CUDA division by a host scalar multiplies by its
    # reciprocal, which rounds differently from the kernel's f32 division
    rad = torch.full((kb, B), radius, dtype=f32, device=dev)
    for blk in range((A - CARRY) // kb):
        i0 = CARRY + blk * kb
        t, q = a_t[i0:i0 + kb], a_q[i0:i0 + kb]
        d, g = a_d[i0:i0 + kb], a_g[i0:i0 + kb]
        v = g >= 0
        coef = 1.0 - (0.2 * d) / rad
        init = coef * dim
        r_s, r_t, r_q, r_g, r_stt, r_stq, r_n, r_sd = rg
        tdiff = t[:, None, :] - r_t[None]                     # [kb, RING, B]
        qdiff = q[:, None, :] - r_q[None]
        ok = ((r_g[None] == g[:, None, :]) & (tdiff > 0) & (qdiff > 0)
              & (r_t[None] + cfg.max_target_gap_length >= t[:, None, :]))
        gap = torch.abs(tdiff - qdiff)
        gs = torch.where(tdiff > 0, qdiff.to(f32) / tdiff.to(f32), 1.0)
        ok &= ((gap < cfg.max_gap_length) & (gs < cfg.max_gap_scale)
               & (gs > cfg.min_gap_scale))
        md = torch.clamp(torch.minimum(tdiff, qdiff), max=dim).to(f32) \
            * coef[:, None, :]
        cand = torch.where(ok, r_s[None] + md, NEG)
        bestc = cand.amax(dim=1)                                # [kb, B]
        bi = torch.where(cand == bestc[:, None, :], kio, RING).amin(dim=1)
        chained = v & (bestc > init)
        s = torch.where(v, torch.where(chained, bestc, init), NEG)
        stt = torch.where(chained, torch.gather(r_stt, 0, bi), t)
        stq = torch.where(chained, torch.gather(r_stq, 0, bi), q)
        n = torch.where(chained, torch.gather(r_n, 0, bi) + 1, 1)
        sumd = torch.where(chained, torch.gather(r_sd, 0, bi) + d, d)
        scores[i0:i0 + kb] = s
        stt_s[i0:i0 + kb] = stt
        best = _best(best, (s, g, t, q, stt, stq, n, sumd))
        cur = _push(rg, cur, (s, t, q, g, stt, stq, n, sumd), v, RING)

    s1, g1, te1, qe1, stt1, stq1, n1, sumd1 = best

    # ---- chain 2 and chain 3 ---------------------------------------------
    def overlaps(gg, st, te):
        return (((a_g >> 1) == (gg >> 1)[None, :])
                & (torch.maximum(stt_s, st[None, :])
                   <= torch.minimum(a_t, te[None, :])))

    excl1 = overlaps(g1, stt1, te1)
    s2 = torch.where(excl1, NEG, scores).amax(dim=0)
    hit = ~excl1 & (scores == s2[None, :]) & (scores > NEG * 0.5)
    rio = torch.arange(A, device=dev)[:, None]
    first = torch.where(hit, rio, A).amin(dim=0)
    found2 = first < A
    fi = torch.clamp(first, max=A - 1)[None, :]
    g2 = torch.where(found2, torch.gather(a_g, 0, fi)[0], -1)
    stt2 = torch.where(found2, torch.gather(stt_s, 0, fi)[0], 0)
    te2 = torch.where(found2, torch.gather(a_t, 0, fi)[0], 0)
    excl2 = found2[None, :] & overlaps(g2, stt2, te2)
    s3 = torch.where(excl1 | excl2, NEG, scores).amax(dim=0)

    zf = torch.zeros(B, dtype=f32, device=dev)
    zi = torch.zeros(B, dtype=i32, device=dev)
    sum_f = torch.stack([s1, s2, sumd1, s3, zf, zf, zf, zf])
    sum_i = torch.stack([g1, stt1, te1, stq1, qe1, n1, zi, zi])
    r_s, r_t, r_q, r_g, r_stt, r_stq, r_n, r_sd = rg
    return sum_f, sum_i, (r_t, r_q, r_g, r_s, r_stt, r_stq, r_n, r_sd)


def chain_fused(a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd,
                radius: float, dim: int = 6, ring: int = 64,
                cfg: ChainingConfig = ChainingConfig(), kb: int = 1,
                window_rows: int | None = None):
    """B4 wrapper (see the module docstring for layouts).  ``window_rows``
    sets the kernel's window of new rows, a multiple of kb; by default a
    read that fits is taken whole and any other in ``default_window``.
    Only tests and chip_smoke.py set it, to cross many windows at a small
    size or to time another window; the results do not depend on it."""
    dev = a_t.device
    if dev.type == "cpu":
        return chain_fused_plain(a_t, a_q, a_d, a_g, c_score, c_stt, c_stq,
                                 c_n, c_sumd, radius, dim, ring, cfg, kb)
    if dev.type != "cuda":
        raise ValueError(f"chain_fused: unsupported device {dev}")
    A, B = a_t.shape
    CARRY = c_score.shape[0]
    if (A - CARRY) % kb or not 1 <= kb <= 32:
        raise ValueError(f"chain_fused: anchor rows {A - CARRY} must tile by "
                         f"kb={kb} (1 <= kb <= 32)")
    ins = [(a_t, torch.int32, A), (a_q, torch.int32, A),
           (a_d, torch.float32, A), (a_g, torch.int32, A),
           (c_score, torch.float32, CARRY), (c_stt, torch.int32, CARRY),
           (c_stq, torch.int32, CARRY), (c_n, torch.int32, CARRY),
           (c_sumd, torch.float32, CARRY)]
    for x, dt, rows in ins:
        if (x.dtype != dt or x.shape != (rows, B) or not x.is_contiguous()
                or x.device != dev):
            raise ValueError("chain_fused: inputs must be contiguous [rows, B]"
                             " i32/f32 tensors on one device")
    W = check_fits(A, CARRY, ring, kb, window_rows)
    lib = kernels()
    f32, i32 = torch.float32, torch.int32
    # windowed: each read's valid rows' (t, g, chain start, score)
    scratch = torch.empty((B, A, 4), dtype=i32, device=dev) if W else None
    sum_f = torch.empty((8, B), dtype=f32, device=dev)
    sum_i = torch.empty((8, B), dtype=i32, device=dev)
    outs = [torch.empty((ring, B), dtype=dt, device=dev)
            for dt in (i32, i32, i32, f32, i32, i32, i32, f32)]
    err = lib.sig_chain_fused_launch(
        *(x.data_ptr() for x, _, _ in ins), A, B, CARRY, ring, kb, W,
        float(radius), dim, cfg.max_gap_length, cfg.max_target_gap_length,
        float(cfg.max_gap_scale), float(cfg.min_gap_scale),
        scratch.data_ptr() if W else None, sum_f.data_ptr(), sum_i.data_ptr(),
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "chain_fused")
    count_launch("chain_fused")
    return sum_f, sum_i, tuple(outs)
