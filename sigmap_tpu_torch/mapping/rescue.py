"""The rescue's radius search on the card, exact against the host k-d tree.

A rescued read (``TurboMapper._rescue_one``) runs the exact engine
(``oracle.Oracle.streaming_read``), whose every chunk asks for all index
windows within ``radius_sq`` of some 200 seeds, as
``native.KdTree.radius_batch`` answers on the host.  ``CardSearch`` answers
the same query over the tile store the turbo rounds already hold on the
card, in three steps:

1. on the host, the seeds are rotated into the store's basis and given the
   block table of ``sweep_search.prepare_round``, for the candidate radius
   ``radius_sq * (1 + EPS)`` and one seed a block
   (``ops/rescue_search.py:BLOCK``), with its probe cells one wider per
   leading dim where that radius needs it (``probe_span``);
2. the kernel (``ops/rescue_search.py``) lists every window whose rotated
   f32 d^2 lies below the candidate radius;
3. on the host, each candidate's d^2 is recomputed from ``index.values``
   as ``kd_radius_rec`` does (f32, dims in order, no contraction) and the
   strict ``d^2 < radius_sq`` kept.

Steps 1 and 3 are ``csrc/rescue_host.cc``.  On a GPU the three steps and
the copies between them are one call into the kernel library
(``sig_rescue_search_card``), which gives up the interpreter lock once a
chunk, as the tree's search did: the rescue threads share that lock with
the mapper's caller and prepare thread, and a thread that gives it up
waits up to the switch interval (5 ms) to get it back while another runs
Python, so a search made of some fifty numpy and torch calls took longer
under load than the tree's (``yeast.short``, PERF.md §6).  On the
CPU (tests) the steps are three calls, the kernel's plain version between
the table and the check.  Both take the probe offsets a seed and the room
for candidates from ``CardSearch.__call__``, which sizes the buffers.

The rotation moves a d^2 by a rounding error some 1e-5 of the radius
(``tests/test_torch_rescue_search.py`` and ``chip_smoke.py`` measure it),
so with ``EPS`` 100 times that and more no match of the tree lies outside
the candidates, and the answer is the tree's: the same windows with the
same distances for every query, grouped by query in order and by window
within one (the tree's order within a query differs; the chaining sorts
anchors by a total order and does not see it).

Every chunk runs on the card but one in which a query has more matches
than ``per_cap``: the tree keeps a subset of them then, which depends on
its traversal order, so ``CardSearch`` returns None and the caller searches
the tree.  The threads of a mapper share one ``CardSearch``: one stream and
one set of buffers, made at first use and reused, 1.5 MiB of device memory
(``IN_WORDS``, ``OUT_WORDS``), which the caching allocator takes from its
small pool.  A chunk whose table or candidates need more grows them to its
size (the kernel counts every candidate, so a chunk past the buffer is
searched again with room for all of them), and they stay that size.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .. import _build
from ..ops.rescue_search import rescue_search

# candidate radius over the search radius, less 1
EPS = 1.0e-2
# the buffers' first sizes (i32 words): the table of 1,024 seeds at 64
# probe offsets a seed (span 4 over 3 leading dims), and the counts and
# some 87,000 candidates (1 MiB)
IN_WORDS = 1024 * (8 + 2 * 64 + 1)
OUT_WORDS = 1 << 18


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def probe_span(radius: float, cell_width: float) -> int:
    """Cells a ball of squared radius ``radius`` may straddle per dim on a
    grid of ``cell_width``."""
    return math.ceil(2.0 * math.sqrt(radius) / cell_width) + 1


def host_arrays(store) -> tuple:
    """The store's rotation, mean and grid origin (f32) and radixes (i64)
    as host arrays, for ``block_table``."""
    return (*(np.ascontiguousarray(t.cpu().numpy(), np.float32)
              for t in (store.rot, store.mu, store.origin)),
            np.asarray(store.radixes, np.int64))


def block_table(queries: np.ndarray, store, host: tuple, radius: float,
                span: int, NO: int, out: np.ndarray):
    """``sweep_search.prepare_round`` for blocks of one seed, written to
    ``out`` (i32, at least nq * (8 + 2*NO + 1) words): the rotated seeds
    [nq, 8] f32 sorted by lo-corner cell key, then blockmeta [2*NO+1, nq]
    i32, NO = span^(leading dims) the probe offsets of a seed.  ``host`` is
    ``host_arrays``'.  Returns (the words written, the query of each sorted
    row)."""
    nq, dim = queries.shape
    rot, mu, origin, radixes = host
    rows = np.empty(nq, np.int32)
    n = _build.rescue_host().sig_rescue_table(
        _ptr(queries), nq, dim, _ptr(rot), _ptr(mu), _ptr(origin),
        _ptr(radixes), len(radixes), store.cell_width, radius, span, NO,
        _ptr(store.cum_host), len(store.cum_host), store.tiles.shape[0],
        store.tile, _ptr(out), _ptr(rows))
    return n, rows


class CardSearch:
    """``KdTree.radius_batch``'s query over a mapper's tile store (module
    docstring).  Calling it gives (fi, fd, fc) as radius_batch does, or None
    where a query passes ``per_cap`` and the tree has to answer."""

    def __init__(self, store, index, device):
        self.store = store
        self.host = host_arrays(store)
        self.values = np.ascontiguousarray(index.values, np.float32)
        self.device = torch.device(device)
        self._lock = threading.Lock()   # the buffers and the launch count
        self._use = threading.Lock()    # the buffers' use, on the CPU
        self._stream = None
        self._bufs = None

    def _buffers(self, n_in: int, n_out: int) -> tuple:
        """(device in, device out, host in, host out) i32 buffers of at
        least ``n_in`` and ``n_out`` words, made at first use and grown where
        a chunk needs more; on a GPU the host buffers are pinned, on the CPU
        they are the device ones.  A caller holds the tuple while it uses
        it, so buffers that another thread grows away from live until that
        use ends."""
        with self._lock:
            b = self._bufs
            if b is None or b[0].numel() < n_in or b[1].numel() < n_out:
                sizes = (max(n_in, IN_WORDS, b[0].numel() if b else 0),
                         max(n_out, OUT_WORDS, b[1].numel() if b else 0))
                if self.device.type == "cuda":
                    if self._stream is None:
                        self._stream = torch.cuda.Stream(self.device,
                                                         priority=-1)
                    with torch.cuda.stream(self._stream):
                        dev = tuple(torch.empty(n, dtype=torch.int32,
                                                device=self.device)
                                    for n in sizes)
                    host = tuple(torch.empty(n, dtype=torch.int32,
                                             pin_memory=True) for n in sizes)
                else:
                    dev = host = tuple(torch.empty(n, dtype=torch.int32)
                                       for n in sizes)
                self._bufs = b = (*dev, *host)
        return b

    def __call__(self, queries: np.ndarray, radius_sq: float,
                 per_cap: int = 5000):
        st = self.store
        queries = np.ascontiguousarray(queries, np.float32)
        nq = len(queries)
        radius_c = float(radius_sq) * (1.0 + EPS)
        span = probe_span(radius_c, st.cell_width)
        NO = span ** (len(st.radixes) - 1)
        rows = np.empty(nq, np.int32)
        fc = np.empty(nq, np.int32)
        total = np.zeros(1, np.int64)
        search = self._on_card if self.device.type == "cuda" else self._on_cpu
        while True:
            bufs = self._buffers(nq * (8 + 2 * NO + 1),
                                 1 + nq + 3 * int(total[0]))
            cap = (bufs[1].numel() - 1 - nq) // 3
            fi = np.empty(cap, np.int32)
            fd = np.empty(cap, np.float32)
            m = search(bufs, queries, radius_c, span, NO, cap, radius_sq,
                       per_cap, rows, fi, fd, fc, total)
            if m != -1:     # else the candidates passed cap: room for all
                break
        if m == -2:
            return None
        return fi[:m], fd[:m], fc

    def _on_card(self, bufs, queries, radius_c, span, NO, cap, radius_sq,
                 per_cap, rows, fi, fd, fc, total) -> int:
        """The chunk's search as one call into the kernel library."""
        st = self.store
        d_in, d_out, h_in, h_out = bufs
        rot, mu, origin, radixes = self.host
        launched = np.zeros(1, np.int32)
        m = _build.kernels().sig_rescue_search_card(
            self.device.index or 0, _ptr(queries), *queries.shape, _ptr(rot),
            _ptr(mu), _ptr(origin), _ptr(radixes), len(radixes),
            st.cell_width, radius_c, span, NO, _ptr(st.cum_host),
            len(st.cum_host), st.tiles.data_ptr(), st.tiles.shape[0], st.tile,
            _ptr(st.perm), _ptr(self.values), radius_sq, per_cap,
            h_in.data_ptr(), d_in.data_ptr(), h_out.data_ptr(),
            d_out.data_ptr(), cap, self._stream.cuda_stream, _ptr(rows),
            _ptr(fi), _ptr(fd), _ptr(fc), _ptr(total), _ptr(launched))
        if launched[0]:
            with self._lock:        # the rescue threads count one key
                _build.count_launch("rescue_search")
        if m <= -1000:
            _build.check(int(-m - 1000), "rescue_search")
        return m

    def _on_cpu(self, bufs, queries, radius_c, span, NO, cap, radius_sq,
                per_cap, rows, fi, fd, fc, total) -> int:
        """The chunk's search in three calls: the table, the kernel's plain
        version, the exact check."""
        st = self.store
        nq, dim = queries.shape
        d_in, d_out, _, _ = bufs
        n_out = 1 + nq + 3 * cap
        with self._use:
            n_in, rows[:] = block_table(queries, st, self.host, radius_c,
                                        span, NO, d_in.numpy())
            rescue_search(d_in[:nq * 8].view(torch.float32).view(nq, 8),
                          d_in[nq * 8:n_in].view(2 * NO + 1, nq), st.tiles,
                          radius_c, dim, d_out[:n_out])
            out = d_out[:n_out].numpy().copy()
        total[0] = out[0]
        return _build.rescue_host().sig_rescue_exact(
            _ptr(out), nq, cap, _ptr(rows), _ptr(st.perm),
            _ptr(self.values), _ptr(queries), dim, radius_sq, per_cap,
            _ptr(fi), _ptr(fd), _ptr(fc))
