"""The plain reference that decides ``correct``.

It re-maps reads from the same inputs the program was handed (the genome,
the pore model's levels, each read's pA and the composition of its read
batch) and nothing that the program made: it builds its own signal index
(``index``) and sweep tile store (``sweep_index``), runs the batch head
(``events``), the rounds with their stop rules and output decision
(``rounds``) and, for a read whose rounds end unmapped after a capacity
overflow, the exact engine (``rescue``).  It imports nothing of the port
or of JAX.  It builds and runs on the device it is given, after the
program's state has been freed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import events, index, rescue, rounds, sweep_index
from .config import SigmapConfig


@dataclass
class ReadIn:
    """A read as the reference takes it: its pA, its DAC affine and the
    chunk bucket of the read batch it was mapped in."""

    name: str
    pa: np.ndarray
    digitisation: float
    range: float
    offset: float
    nc: int

    @property
    def length(self) -> int:
        return len(self.pa)


# Seeds a block of the reference's sweep.  A seed's matches and slots
# depend only on the tiles that hold its own cells, visited in tile order,
# so the blocking is free; the program's blocks of 32 neighbours in a batch
# of thousands of reads cover few tiles, but in a sample of some tens of
# reads neighbours lie far apart, and one seed a block visits the fewest.
SWEEP_BLOCK = 1

# the reference's chunk-count buckets (turbo.py:_NC_BUCKETS)
NC_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 30)


def nc_bucket(lengths, cfg: SigmapConfig) -> int:
    """The chunk bucket of a read batch of pA ``lengths`` (the longest
    read's full chunks, capped at max_num_chunks)."""
    m = cfg.mapping
    nc_raw = max(1, max((min(n // m.chunk_size, m.max_num_chunks)
                         for n in lengths), default=1))
    return next((nc for nc in NC_BUCKETS
                 if nc >= nc_raw or nc >= m.max_num_chunks), NC_BUCKETS[-1])


class Reference:
    """The reference of one genome: its index and tile store."""

    def __init__(self, genome, pore, params: dict, device,
                 cfg: SigmapConfig = SigmapConfig()):
        self.cfg = cfg
        self.p = rounds.TurboParams(**dict(params, block=SWEEP_BLOCK))
        self.dev = torch.device(device)
        self.seconds = {}           # where the reference's time went
        m = cfg.mapping
        t = time.perf_counter()
        self.idx = index.build(genome, pore, cfg.index, m.search_radius,
                               self.dev)
        self._sync()
        self.seconds["index"] = time.perf_counter() - t
        t = time.perf_counter()
        self.store = sweep_index.build(self.idx, m.search_radius,
                                       tile=self.p.TILE)
        self._sync()
        self._search = None
        self.seconds["tile_store"] = time.perf_counter() - t

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def search(self):
        if self._search is None:
            self._search = rescue.RadiusSearch(self.idx, self.dev)
        return self._search

    def map_rounds(self, reads: list, precision: str = "f32") -> list:
        """The turbo rounds on ``reads`` (ReadIn) as one batch: a read's
        result depends on its own samples and its batch's chunk bucket
        alone.  Returns (record, overflow, needs the rescue) per read."""
        t0 = time.perf_counter()
        cfg, p, dev = self.cfg, self.p, self.dev
        m = cfg.mapping
        Cs = m.chunk_size
        B = len(reads)
        NC = max(r.nc for r in reads)
        pa, L, scale, off, n_full = events.stage_batch(
            reads, B, NC, Cs, m.max_num_chunks)
        # each read's transport window is its own batch's: L = min(length,
        # its batch's NC * Cs)
        L = np.array([min(r.length, r.nc * Cs) for r in reads], np.int32)
        q, qoff, qscale = events.quantize(pa.to(dev), L, scale, off)
        q = q.reshape(B, NC, Cs)
        n_full_d = torch.from_numpy(n_full).to(dev)
        chunk_ok = torch.arange(NC, device=dev)[None, :] < n_full_d[:, None]
        clen = torch.where(chunk_ok, Cs, 0).to(torch.int32).reshape(-1)
        feats, counts = events.rows_features(
            q.reshape(B * NC, Cs), qoff[:, None].expand(B, NC).reshape(-1),
            qscale[:, None].expand(B, NC).reshape(-1), clen, cfg.event,
            p.max_events, p.max_features, m.compress_delta, precision)
        feats = feats.reshape(B, NC, -1)
        counts = counts.reshape(B, NC)
        t1 = time.perf_counter()
        st = rounds.init_round_state(B, p.RING, dev)
        done = n_full == 0
        r = 0
        while not done.all():
            st, _, host_sig = rounds.turbo_round(
                self.store, feats[:, r], counts[:, r], n_full_d, st, p,
                m.step_size, m.search_radius, self.idx.dim, cfg.chain, m)
            done = host_sig.cpu().numpy()[:B].astype(bool)
            r += 1
        rb_f = st.rb_f.cpu().numpy()
        rb_i = st.rb_i.cpu().numpy()
        chunk_idx = st.chunk_idx.cpu().numpy()
        stopped = st.stopped.cpu().numpy()
        offsets = st.offsets.cpu().numpy()
        out = []
        for i, rd in enumerate(reads):
            rec, resc = rounds.emit(
                cfg, self.idx.ref_lengths, rd.name, rd.length, rb_f[:, i],
                rb_i[:, i], int(chunk_idx[i]), bool(stopped[i]),
                int(offsets[i]), int(n_full[i]))
            out.append((rec, bool(rb_i[7, i]), resc and p.rescue))
        self._add("head", t1 - t0)
        self._add("rounds", time.perf_counter() - t1)
        return out

    def _add(self, key: str, s: float) -> None:
        self.seconds[key] = self.seconds.get(key, 0.0) + s

    def rescue(self, read: ReadIn):
        """The exact engine's record of ``read`` (may raise
        rescue.Undecided)."""
        t = time.perf_counter()
        try:
            return rescue.rescue_record(read.name, read.pa, self.idx,
                                        self.search(), self.cfg)
        finally:
            self._add("rescue", time.perf_counter() - t)
