"""Kernel rescue_search: the rescue chunk's candidates over the tile store.

CUDA source: ``sigmap_tpu_torch/csrc/rescue_search.cu``.  It replaces no TPU
kernel: it takes the place of the host k-d tree search in the rescue
(``mapping/rescue.py`` holds the exact check around it).  The wrapper runs
the plain version on a CPU tensor and launches the kernel on a CUDA tensor.

Contract (identical for both): seeds [Q, 8] f32 rotated and sorted by cell
key, Q a multiple of ``BLOCK``; blockmeta [2*NO+1, Q//BLOCK] i32 (rows
0..NO-1 first tile per offset, rows NO..2*NO the exclusive tile cumsum, B3's
format); tiles [T, 8, TILE] f32.  ``out`` [1 + Q + 3*cap] i32 is filled in
place: out[0] the candidates of every seed and out[1+q] those of seed q
(each window of the seed's block's tiles with f32 d^2 < ``radius``, dims in
order), both exact, then the first min(out[0], cap) candidates as rows of
(tile slot t * TILE + lane, row of ``seeds``, bits of the f32 d^2).  The
kernel appends with atomics, so the candidates' order is not fixed; the
plain version writes them by tile step, seed and lane.  The mapper's card
search launches the kernel from the kernel library itself
(``sig_rescue_search_card``, ``mapping/rescue.py``); this wrapper serves the
CPU path, the tests and ``chip_smoke.py``'s check of the kernel against its
plain version on a main-path chunk.
"""

from __future__ import annotations

import torch

from .._build import check, count_launch, kernels
from .sweep_kernel import _tile_of

BLOCK = 1   # seeds a CTA (csrc/rescue_search.cu:kBlock)


def candidate_cap(out, Q: int) -> int:
    """Candidates ``out`` holds after the counts of Q seeds."""
    return (out.shape[0] - 1 - Q) // 3


def rescue_search_plain(seeds, blockmeta, tiles, radius: float, dim: int,
                        out):
    """Plain version: a loop over the blocks' tile steps, vectorised over
    the blocks that have that step."""
    dev = seeds.device
    Q = seeds.shape[0]
    G = Q // BLOCK
    NO = (blockmeta.shape[0] - 1) // 2
    TILE = tiles.shape[2]
    radius32 = torch.tensor(radius, dtype=torch.float32, device=dev)
    starts = blockmeta[:NO].t().to(torch.int64)                  # [G, NO]
    cums = blockmeta[NO:].t().to(torch.int64)                    # [G, NO+1]
    total = cums[:, NO]
    sq = seeds.view(G, BLOCK, 8)[:, :, :dim]
    rows = []
    n_steps = int(total.max().item()) if G else 0
    for s in range(n_steps):
        act = torch.nonzero(total > s).squeeze(1)
        t = _tile_of(starts[act], cums[act], s)
        wt = tiles[t, :dim, :]                          # [nb, dim, TILE]
        q = sq[act]                                     # [nb, BLOCK, dim]
        acc = torch.zeros((act.numel(), BLOCK, TILE), dtype=torch.float32,
                          device=dev)
        for d in range(dim):
            diff = wt[:, d, None, :] - q[:, :, d, None]
            acc = acc + diff * diff
        b, j, w = torch.nonzero(acc < radius32, as_tuple=True)
        rows.append(torch.stack(
            [(t[b] * TILE + w).to(torch.int32),
             (act[b] * BLOCK + j).to(torch.int32),
             acc[b, j, w].view(torch.int32)], dim=1))
    cand = (torch.cat(rows) if rows
            else torch.zeros((0, 3), dtype=torch.int32, device=dev))
    n = min(cand.shape[0], candidate_cap(out, Q))
    out[0] = cand.shape[0]
    out[1:1 + Q] = torch.bincount(cand[:, 1].to(torch.int64),
                                  minlength=Q).to(torch.int32)
    out[1 + Q:1 + Q + 3 * n] = cand[:n].reshape(-1)


def rescue_search(seeds, blockmeta, tiles, radius: float, dim: int, out):
    """The rescue search's wrapper (see the module docstring)."""
    dev = seeds.device
    if dev.type == "cpu":
        return rescue_search_plain(seeds, blockmeta, tiles, radius, dim, out)
    if dev.type != "cuda":
        raise ValueError(f"rescue_search: unsupported device {dev}")
    Q = seeds.shape[0]
    T = tiles.shape[0]
    TILE = tiles.shape[2]
    if Q % BLOCK or seeds.shape[1] != 8:
        raise ValueError("rescue_search: seeds must be [Q, 8], Q % BLOCK "
                         "== 0")
    if tiles.shape != (T, 8, TILE) or TILE % 256 or not 1 <= dim <= 8:
        raise ValueError("rescue_search: tiles must be [T, 8, TILE] with "
                         "TILE a multiple of 256, dim in 1..8")
    G = Q // BLOCK
    NO = (blockmeta.shape[0] - 1) // 2
    if blockmeta.shape != (2 * NO + 1, G):
        raise ValueError("rescue_search: blockmeta shape mismatch")
    if out.dim() != 1 or candidate_cap(out, Q) < 0:
        raise ValueError("rescue_search: out must be [1 + Q + 3*cap]")
    for x, dt in ((seeds, torch.float32), (blockmeta, torch.int32),
                  (tiles, torch.float32), (out, torch.int32)):
        if x.dtype != dt or not x.is_contiguous() or x.device != dev:
            raise ValueError("rescue_search: inputs must be contiguous "
                             "f32/i32 tensors on one device")
    err = kernels().sig_rescue_search_launch(
        seeds.data_ptr(), blockmeta.data_ptr(), G, NO, tiles.data_ptr(),
        TILE, float(radius), dim, BLOCK, candidate_cap(out, Q),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "rescue_search")
    count_launch("rescue_search")
