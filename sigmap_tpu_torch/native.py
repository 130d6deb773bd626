"""ctypes bindings for the native C++ host core (csrc/core.cc).

The library is compiled by ``_build.native_library`` (g++) into the port's
build directory on first use.  Provides:

* :func:`dedup` — sequential point-cloud dedup (spatial_index.cc:33-57);
* :class:`KdTree` — exact radius-search oracle with nanoflann-parity
  semantics (strict ``dist^2 < radius``);
* :func:`chain_scores` — chaining DP with the reference's exact band/skip
  behavior (spatial_index.cc:418-550).

Every entry point has a numpy fallback (slow, small inputs only) so the
pure-Python path still works without a toolchain; ``_build.native()`` is the
checked entry point that raises when the library does not build or load.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SO: Path | None = None   # set by _build.native(), else built on first use
_lib = None


def _load():
    global _lib, _SO
    if _lib is not None:
        return _lib
    if _SO is None:
        from ._build import native_library

        try:
            _SO = native_library()
        except Exception:  # noqa: BLE001 - no toolchain: numpy fallbacks
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    c = ctypes
    lib.sig_dedup.restype = c.c_int64
    lib.sig_dedup.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_float, c.c_void_p,
    ]
    lib.sig_dedup_stream.restype = c.c_int64
    lib.sig_dedup_stream.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_float, c.c_float, c.c_int32,
        c.c_void_p, c.c_void_p,
    ]
    lib.sig_kd_build.restype = c.c_void_p
    lib.sig_kd_build.argtypes = [c.c_void_p, c.c_int64, c.c_int32, c.c_int32]
    lib.sig_kd_layout.restype = c.c_int64
    lib.sig_kd_layout.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                  c.c_void_p]
    lib.sig_kd_free.argtypes = [c.c_void_p]
    lib.sig_kd_radius.restype = c.c_int64
    lib.sig_kd_radius.argtypes = [
        c.c_void_p, c.c_void_p, c.c_float, c.c_void_p, c.c_void_p, c.c_int64,
    ]
    lib.sig_kd_radius_batch.restype = c.c_int64
    lib.sig_kd_radius_batch.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_float, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_int64,
    ]
    lib.sig_chain_scores.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_float, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_void_p, c.c_void_p,
    ]
    lib.sig_features.restype = c.c_int64
    lib.sig_features.argtypes = [
        c.c_void_p, c.c_int64, c.c_int32, c.c_int32, c.c_float, c.c_float,
        c.c_float, c.c_float, c.c_void_p, c.c_void_p, c.c_int64,
    ]
    lib.sig_kmer_count.restype = c.c_int64
    lib.sig_kmer_count.argtypes = [
        c.c_void_p, c.c_int64, c.c_int32, c.c_void_p,
    ]
    lib.sig_kmer_mask.argtypes = [
        c.c_void_p, c.c_int64, c.c_int32, c.c_void_p, c.c_int64, c.c_float,
        c.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def dedup(
    vals: np.ndarray, masked: np.ndarray | None, delta: float,
    prev_val: float | None = None,
) -> tuple[np.ndarray, float | None]:
    """Kept-position indices after consecutive dedup over one stream.

    prev_val: last kept value of the preceding stream (the reference's
    cross-stream point_cloud.back() comparison, spatial_index.cc:43-46);
    None for the first stream.  Returns (indices, last_kept_value).
    """
    vals = np.ascontiguousarray(vals, np.float32)
    n = len(vals)
    lib = _load()
    if lib is not None:
        m = (
            np.ascontiguousarray(masked, np.uint8)
            if masked is not None
            else None
        )
        out = np.empty(max(n, 1), np.int32)
        last = np.zeros(1, np.float32)
        cnt = lib.sig_dedup_stream(
            _ptr(vals), _ptr(m) if m is not None else None, n,
            ctypes.c_float(delta),
            ctypes.c_float(prev_val if prev_val is not None else 0.0),
            1 if prev_val is not None else 0,
            _ptr(out), _ptr(last),
        )
        new_last = float(last[0]) if (cnt > 0 or prev_val is not None) else None
        return out[:cnt].copy(), new_last
    # numpy/python fallback (small inputs)
    keep = []
    last = prev_val
    for i in range(n):
        if masked is not None and masked[i]:
            continue
        if i == 0 or last is None or abs(float(vals[i]) - last) > delta:
            keep.append(i)
            last = float(vals[i])
    return np.array(keep, np.int32), last


def kmer_masks(
    pos_codes_list, neg_codes_list, k: int, frequency: float
):
    """Canonical k-mer masking for all sequences/strands (sigmap.cc:19-185).
    Returns (pos_masks, neg_masks) lists of bool arrays, or None if the
    native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    hist = np.zeros(1 << (2 * k), np.int64)
    num = 0
    pos_codes_list = [np.ascontiguousarray(c, np.uint8) for c in pos_codes_list]
    neg_codes_list = [np.ascontiguousarray(c, np.uint8) for c in neg_codes_list]
    for codes in pos_codes_list:
        num += lib.sig_kmer_count(_ptr(codes), len(codes), k, _ptr(hist))
    out = ([], [])
    for strand, lst in enumerate((pos_codes_list, neg_codes_list)):
        for codes in lst:
            m = np.zeros(max(len(codes) - k + 1, 0), np.uint8)
            if len(m):
                lib.sig_kmer_mask(
                    _ptr(codes), len(codes), k, _ptr(hist), num,
                    ctypes.c_float(frequency), _ptr(m),
                )
            out[strand].append(m.astype(bool))
    return out


def features(
    signal: np.ndarray, w1: int = 3, w2: int = 6, thresh1: float = 4.30265,
    thresh2: float = 2.57058, peak_height: float = 1.0,
    compress_delta: float = 0.1,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native event detection -> compressed feature signal (accurate-twin
    semantics of signal/events_ref.generate_events(accurate_tstat=True)).
    Returns None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    sig = np.ascontiguousarray(signal, np.float32)
    cap = len(sig) + 2
    feats = np.empty(cap, np.float32)
    stdvs = np.empty(cap, np.float32)
    m = lib.sig_features(
        _ptr(sig), len(sig), w1, w2, ctypes.c_float(thresh1),
        ctypes.c_float(thresh2), ctypes.c_float(peak_height),
        ctypes.c_float(compress_delta), _ptr(feats), _ptr(stdvs), cap,
    )
    return feats[:m].copy(), stdvs[:m].copy()


class KdTree:
    """Exact k-d tree over overlapping windows of a flat value array.

    Point i coords = vals[i + d], d in [0, dim); n_points = len(vals)-dim+1.
    Built on every core the process may run on (its affinity mask); the
    tree, and so every answer, is the same on any number of them.
    """

    def __init__(self, vals: np.ndarray, dim: int, max_leaf: int = 20):
        self.vals = np.ascontiguousarray(vals, np.float32)
        self.dim = dim
        self.n_points = len(self.vals) - dim + 1
        self._lib = _load()
        self._tree = None
        if self._lib is not None:
            self._tree = self._lib.sig_kd_build(
                _ptr(self.vals), len(self.vals), dim, max_leaf
            )

    def layout(self):
        """(order [n_points] i32, links [n_nodes, 5] i32, splits [n_nodes]
        f32): the windows in leaf order, and each node's left, right,
        begin, end and split dim, and its split value."""
        n = self._lib.sig_kd_layout(self._tree, None, None, None)
        order = np.empty(max(self.n_points, 0), np.int32)
        links = np.empty((n, 5), np.int32)
        splits = np.empty(n, np.float32)
        self._lib.sig_kd_layout(self._tree, _ptr(order), _ptr(links),
                                _ptr(splits))
        return order, links, splits

    def __del__(self):
        if getattr(self, "_tree", None) and self._lib is not None:
            self._lib.sig_kd_free(self._tree)
            self._tree = None

    def radius(self, q: np.ndarray, radius_sq: float, cap: int = 1 << 22):
        """Strict dist^2 < radius_sq matches: (indices, dists)."""
        q = np.ascontiguousarray(q, np.float32)
        if self._tree:
            oi = np.empty(cap, np.int32)
            od = np.empty(cap, np.float32)
            m = self._lib.sig_kd_radius(
                self._tree, _ptr(q), ctypes.c_float(radius_sq), _ptr(oi),
                _ptr(od), cap,
            )
            return oi[:m].copy(), od[:m].copy()
        # numpy brute force fallback
        W = np.lib.stride_tricks.sliding_window_view(self.vals, self.dim)
        d = ((W - q[None, :]) ** 2).sum(axis=1)
        sel = np.nonzero(d < radius_sq)[0]
        return sel.astype(np.int32), d[sel].astype(np.float32)

    def radius_batch(self, queries: np.ndarray, radius_sq: float,
                     per_cap: int = 5000):
        """queries [nq, dim] -> (flat indices, flat dists, counts [nq])."""
        queries = np.ascontiguousarray(queries, np.float32)
        nq = len(queries)
        if self._tree:
            cap_total = int(nq) * per_cap
            oi = np.empty(cap_total, np.int32)
            od = np.empty(cap_total, np.float32)
            oc = np.empty(nq, np.int32)
            self._lib.sig_kd_radius_batch(
                self._tree, _ptr(queries), nq, ctypes.c_float(radius_sq),
                _ptr(oi), _ptr(od), _ptr(oc), per_cap,
            )
            total = int(oc.sum())
            return oi[:total].copy(), od[:total].copy(), oc
        idxs, dists, counts = [], [], []
        for q in queries:
            i_, d_ = self.radius(q, radius_sq)
            idxs.append(i_[:per_cap])
            dists.append(d_[:per_cap])
            counts.append(len(i_[:per_cap]))
        return (
            np.concatenate(idxs) if idxs else np.zeros(0, np.int32),
            np.concatenate(dists) if dists else np.zeros(0, np.float32),
            np.array(counts, np.int32),
        )


def chain_scores(
    target_pos: np.ndarray, query_pos: np.ndarray, dist: np.ndarray,
    search_radius: float, dim: int, max_gap_length: int = 2000,
    max_target_gap_length: int = 5000, band_length: int = 5000,
    max_num_skips: int = 25,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact chaining DP (spatial_index.cc:418-550) over one sorted
    (ref, strand) anchor group.  Returns (scores f32[n], pred i32[n])."""
    n = len(target_pos)
    tp = np.ascontiguousarray(target_pos, np.int32)
    qp = np.ascontiguousarray(query_pos, np.int32)
    dd = np.ascontiguousarray(dist, np.float32)
    scores = np.empty(n, np.float32)
    pred = np.empty(n, np.int32)
    lib = _load()
    if lib is not None and n > 0:
        lib.sig_chain_scores(
            _ptr(tp), _ptr(qp), _ptr(dd), n, ctypes.c_float(search_radius),
            dim, max_gap_length, max_target_gap_length, band_length,
            max_num_skips, _ptr(scores), _ptr(pred),
        )
        return scores, pred
    # python fallback
    for i in range(n):
        coef = 1.0 - 0.2 * float(dd[i]) / search_radius
        scores[i] = np.float32(coef * dim)
        pred[i] = i
        start = i - band_length if i > band_length else 0
        skips = 0
        for j in range(i - 1, start - 1, -1):
            if qp[j] == qp[i] or tp[j] == tp[i]:
                continue
            if tp[j] + max_target_gap_length < tp[i]:
                break
            tdiff = int(tp[i]) - int(tp[j])
            qdiff = int(qp[i]) - int(qp[j])
            if qdiff < 0:
                continue
            cand = np.float32(0.0)
            gap = abs(tdiff - qdiff)
            gap_scale = qdiff / tdiff if tdiff > 0 else 1.0
            if gap < max_gap_length and 0.75 < gap_scale < 5.0:
                cand = np.float32(
                    scores[j] + min(min(tdiff, qdiff), dim) * np.float32(coef)
                )
            if cand > scores[i]:
                scores[i] = cand
                pred[i] = j
                skips -= 1
            else:
                skips += 1
                if skips > max_num_skips:
                    break
    return scores, pred
