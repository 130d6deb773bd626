"""FastDTW with skip costs and per-base signal CIGAR.

Capability-parity implementation of the reference's dormant fast_dtw.cc
(present but absent from the build, Makefile:1): multi-resolution banded
DTW producing an alignment path and a per-base CIGAR-like string.

Reference semantics (fast_dtw.cc):
* transitions per cell (fast_dtw.cc:88,113-114):
    0 one-to-one   diag   prev[q-1] + cost
    1 multi-signal left   cur[q-1] + cost      (one base, many signals)
    2 skip-signal  left   cur[q-1] + skip(2.0)
    3 skip-base    up     prev[q]   + skip(2.0)
* free target start/end: row boundary cur[0] = 0, best over rows whose
  window reaches the last query column (fast_dtw.cc:105,130-133);
* window recursion: half-resolution path, +-radius dilation, 2x upsample
  (fast_dtw.cc:11-49,142-158);
* CIGAR rendering groups flags per base: M (match/multi), I (skip signal),
  D (skip base), one "(...)" group per base (fast_dtw.cc:160-209).
"""

from __future__ import annotations

import numpy as np

SKIP_COST = 2.0

# traceback shifts per direction (fast_dtw.cc:62-63)
_QSHIFT = (-1, -1, -1, 0)
_TSHIFT = (-1, 0, 0, -1)


def reduce_by_half(x: np.ndarray) -> np.ndarray:
    """Pairwise means (fast_dtw.cc:3-9)."""
    n = len(x) - len(x) % 2
    return ((x[0:n:2] + x[1:n:2]) / 2).astype(np.float32)


def _full_window(T: int, Q: int):
    return [np.arange(Q, dtype=np.int64) for _ in range(T)]


def dtw_windowed(target: np.ndarray, query: np.ndarray,
                 window: list[np.ndarray] | None):
    """Banded DTW over a per-row coordinate window.

    Returns (distance, path [(t, q, dir)...] start->end, end_target_pos).
    """
    T, Q = len(target), len(query)
    if window is None:
        window = _full_window(T, Q)
        rows = np.arange(T)
    else:
        rows = np.arange(len(window))
    INF = np.float32(np.inf)
    prev = np.full(Q + 1, INF, np.float32)
    prev[0] = 0.0
    best = INF
    end_row = -1
    dirs: list[np.ndarray] = []
    for r, cols in enumerate(window):
        cur = np.full(Q + 1, INF, np.float32)
        cur[0] = 0.0
        drow = np.zeros(len(cols), np.int8)
        t_val = target[r]
        for ci, qc in enumerate(cols):
            j = qc + 1
            cost = abs(np.float32(t_val) - np.float32(query[qc]))
            cands = (
                prev[j - 1] + cost,      # 0 diag
                cur[j - 1] + cost,       # 1 multi-signal
                cur[j - 1] + SKIP_COST,  # 2 skip signal
                prev[j] + SKIP_COST,     # 3 skip base
            )
            k = int(np.argmin(cands))
            cur[j] = cands[k]
            drow[ci] = k
        dirs.append(drow)
        if len(cols) and cols[-1] == Q - 1 and cur[Q] < best:
            best = cur[Q]
            end_row = r
        prev = cur
    if end_row < 0:
        return float(best), [], -1
    # traceback (fast_dtw.cc:51-72): from (end_row, last col) until query 0
    col_index = {
        (r, int(qc)): ci for r, cols in enumerate(window)
        for ci, qc in enumerate(cols)
    }
    path = []
    r = end_row
    q = int(window[end_row][-1])
    while True:
        d = int(dirs[r][col_index[(r, q)]])
        path.append((r, q, d))
        if q == 0:
            break
        q += _QSHIFT[d]
        r += _TSHIFT[d]
        if r < 0 or (r, q) not in col_index:
            break
    path.reverse()
    return float(best), path, end_row


def expand_window(path, T: int, Q: int, radius: int) -> list[np.ndarray]:
    """Dilate the half-resolution path by radius and upsample 2x
    (fast_dtw.cc:11-49)."""
    cells = set()
    for (t, q, _d) in path:
        for dt in range(-radius, radius + 1):
            for dq in range(-radius, radius + 1):
                cells.add((t + dt, q + dq))
    ups = set()
    for (t, q) in cells:
        for x in (0, 1):
            for y in (0, 1):
                tt, qq = 2 * t + x, 2 * q + y
                if 0 <= tt < T and 0 <= qq < Q:
                    ups.add((tt, qq))
    window: dict[int, list[int]] = {}
    for (t, q) in sorted(ups):
        window.setdefault(t, []).append(q)
    rows = sorted(window)
    # rows must be contiguous for the row-major DP; fill gaps minimally
    out = []
    for t in range(rows[0], rows[-1] + 1):
        cols = window.get(t, [window[min(window, key=lambda r: abs(r - t))][0]])
        out.append(np.array(sorted(cols), np.int64))
    # prepend empty-cost rows before rows[0] so target indices align
    return [np.zeros(0, np.int64)] * rows[0] + out


def fastdtw(target: np.ndarray, query: np.ndarray, radius: int = 1):
    """Multi-resolution DTW (fast_dtw.cc:142-158,211-220).

    Returns (distance, path, end_target_position, cigar).
    """
    dist, path, end = _fastdtw(
        np.asarray(target, np.float32), np.asarray(query, np.float32), radius
    )
    return dist, path, end, print_alignment(path)


def _fastdtw(target, query, radius):
    min_size = radius + 2
    if len(target) < min_size or len(query) < min_size:
        return dtw_windowed(target, query, None)
    t2 = reduce_by_half(target)
    q2 = reduce_by_half(query)
    _, path, _ = _fastdtw(t2, q2, radius)
    if not path:
        return dtw_windowed(target, query, None)
    window = expand_window(path, len(target), len(query), radius)
    return dtw_windowed(target, query, window)


def print_alignment(path) -> str:
    """Per-base signal CIGAR, a behavioral transcription of
    fast_dtw.cc:160-209 including its quirks: flags M (match /
    one-base-multi-signal), I (skip signal), D (skip base); one
    parenthesized group per base; the run in flight when the path ends on a
    0/3 transition is dropped, exactly like the C++."""
    flags = "MMID"
    if not path:
        return ""
    groups: list[str] = []
    d0 = path[0][2]
    if d0 == 3:
        groups.append("1D")
        last = 3
    else:
        last = 1 if d0 == 0 else 2
    groups.append("")
    num = 1
    n = len(path)
    for i in range(1, n):
        d = path[i][2]
        if d in (1, 2):
            if last == d:
                num += 1
            else:
                groups[-1] += f"{num}{flags[last]}"
                num = 1
                last = d
        else:
            groups[-1] += f"{num}{flags[last]}"
            last = 1 if d == 0 else 3
            if i != n - 1:
                groups.append("")
                num = 1
    return "".join(f"({g})" for g in groups)
