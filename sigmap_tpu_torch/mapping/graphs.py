"""CUDA graphs of the turbo mapper's round and batch head.

The port's counterpart of how the JAX package runs its main path: there a
round is one compiled XLA program (``jax.jit(turbo_round)``,
sigmap_tpu/mapping/turbo.py:296-333, over ``turbo_round_body`` at :159),
the round's feature slice a jitted ``slice_chunk`` (:335) and a batch's head
one jitted ``batch_features`` (:373-437) that scans its row blocks.  Here
each is a CUDA graph captured from the eager functions of
``mapping/turbo.py`` and replayed, so that a round's some 800 launches, or a
head block's few hundred, are one call:

* ``RoundGraph``: static inputs (this round's feature slice and counts,
  which take the place of ``slice_chunk``, and ``n_full``) and a static
  ``RoundState``.  A replay runs one round and ends by copying the new
  state and the host signal into the static buffers, so the next replay
  starts from the last one's output with no Python work between.  With a
  merge hook (the sharded mapper) it is two graphs sharing one pool, up to
  the sweep's outputs and from the merged slots on, and the merge runs
  eagerly between them: gloo stages its collectives through the host,
  which no graph can hold.
* ``HeadGraph``: one row block of ``batch_features`` (``rows_features``:
  B1, B2 and their glue) at one block shape.  A batch replays it once a
  block (``turbo.head_blocks``), so the set of head graphs is fixed
  whatever B and NC are.  Each replay's outputs are copied into the
  batch's own tensors at once, on the replay's stream, so no replay
  overwrites a batch whose rounds still read it.  The quantization stays
  outside: it reads each read's fit back to the host, as the JAX package
  keeps it out of its jitted head.

A graph's first call runs its body eagerly (a real round or head, which
also builds and loads the kernels and warms the allocator), then captures
the body; every later call replays it.  On the CPU nothing is captured:
every call runs the same static-buffer code eagerly, which is how the CPU
tests reach it.  A capture or replay that fails raises; nothing falls back
to the eager path.

Capture mode ``thread_local``: the mapper's prepare thread may capture a
head graph on the side stream while the main thread replays rounds and
blocks on each host signal's download, and the main thread may capture a
round graph while the prepare thread quantizes (pageable copies, a
synchronisation).  In the default ``global`` mode either thread's
synchronising call would invalidate the other's capture.  Each capture runs
on a high-priority stream of PyTorch's pool, which nothing else of the
port takes (the side stream and NCCL's are normal priority), so no other
thread's work can land in a capture.  Each graph has its own memory pool
(the two halves of a split round share one, and always replay in the order
they were captured): rounds and heads replay at once on two streams.  A
pool's free blocks serve only captures on the stream that freed them, and
each capture runs on a stream of its own, so a shared pool would not
shrink the heads' memory; halving block sizes bound it instead, to twice
one block's pool.

A kernel wrapper called while its thread captures counts its launch in the
capture's record (``_build.recording_launches``); the graph adds that
record to ``LAUNCHES`` at each replay, where the launches happen.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .._build import add_launches, recording_launches
from .turbo import (PAD_ROW, RoundSearch, RoundState, init_round_state,
                    merged, round_finish, round_search, rows_features)


@dataclass
class Captured:
    """One captured CUDA graph: the launches its capture recorded, the
    capture's host time, the device memory its pool took (the growth of
    ``torch.cuda.memory_reserved`` around the capture, which also holds
    what another thread allocated meanwhile) and its replays."""

    graph: torch.cuda.CUDAGraph
    launches: dict
    capture_ms: float
    pool_bytes: int
    replays: int = 0

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1


def capture(fn, device, pool=None):
    """fn() captured into a CUDA graph on a capture stream of ``device``
    (see the module docstring for the mode and the stream), in the memory
    pool ``pool`` (None: a pool of its own).  Returns (Captured, what fn
    returned: tensors of the graph's pool, rewritten by each replay)."""
    dev = torch.device(device)
    g = torch.cuda.CUDAGraph()
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    with torch.cuda.device(dev), \
            torch.cuda.stream(torch.cuda.Stream(dev, priority=-1)), \
            recording_launches() as launches:
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            _abandon(g)
            raise
        g.capture_end()
    return Captured(g, dict(launches), (time.perf_counter() - t0) * 1000,
                    torch.cuda.memory_reserved(dev) - reserved), out


def _abandon(g) -> None:
    """End a capture that its body broke off.  The capture is invalid, so
    ending it fails too; the body's error is the one that propagates."""
    try:
        g.capture_end()
    except Exception:  # noqa: BLE001 - the body's error is raised instead
        pass


_STATE_FIELDS = ("chunk_idx", "done", "stopped", "offsets", "rb_f", "rb_i")


def _copy_state(dst: RoundState, src: RoundState) -> None:
    for f in _STATE_FIELDS:
        getattr(dst, f).copy_(getattr(src, f))
    for d, s in zip(dst.carry, src.carry):
        d.copy_(s)


def _clone_state(st: RoundState) -> RoundState:
    return RoundState(**{f: getattr(st, f).clone() for f in _STATE_FIELDS},
                      carry=tuple(c.clone() for c in st.carry))


def _stats(name: str, parts: list) -> dict:
    """What a graph's captures (one, or a split round's two) did so far."""
    launches: dict = {}
    for c in parts:
        for k, n in c.launches.items():
            launches[k] = launches.get(k, 0) + n
    return dict(graph=name, captures=len(parts),
                replays=max((c.replays for c in parts), default=0),
                capture_ms=sum(c.capture_ms for c in parts),
                pool_mib=sum(c.pool_bytes for c in parts) / 2**20,
                launches_a_replay=launches)


class RoundGraph:
    """The turbo round of one mapper at one batch shape on static buffers:
    ``start`` a batch, then ``run`` once a round.  ``round_args`` are
    turbo_round's (store, p, step, radius, dim, chain_cfg, m); with
    ``split`` the round is two graphs around an eager merge hook (the
    sharded mapper's), else one."""

    def __init__(self, round_args: tuple, B: int, F: int, device,
                 split: bool = False):
        dev = torch.device(device)
        self.store, *self.args = round_args
        p = self.args[0]
        self.device = dev
        self.split = split
        self.feats = torch.zeros((B, F), dtype=torch.float32, device=dev)
        self.counts = torch.zeros(B, dtype=torch.int32, device=dev)
        self.n_full = torch.zeros(B, dtype=torch.int32, device=dev)
        self._init = init_round_state(B, p.RING, dev)
        self.state = _clone_state(self._init)
        self.host_sig = torch.zeros(B + 2, dtype=torch.uint8, device=dev)
        self.parts: list[Captured] = []
        self._search = None     # split: the first graph's RoundSearch
        self._slots = None      # split: the second graph's merged slots
        self.name = f"round B={B} F={F}" + (" split" if split else "")

    def start(self, n_full) -> None:
        """A batch's round 0 comes next: the state as ``init_round_state``
        makes it, and the batch's ``n_full`` [B]."""
        _copy_state(self.state, self._init)
        self.n_full.copy_(n_full)

    def _search_body(self) -> RoundSearch:
        p, step, radius, dim, _, m = self.args
        return round_search(self.store, self.feats, self.counts, self.n_full,
                            self.state, p, step, radius, dim, m)

    def _finish_body(self, rs: RoundSearch) -> None:
        new, _, host_sig = round_finish(rs, self.n_full, self.state,
                                        *self.args)
        _copy_state(self.state, new)
        self.host_sig.copy_(host_sig)

    def _whole_body(self) -> None:
        self._finish_body(self._search_body())

    def run(self, feats_r, counts_r, merge=None):
        """One round on this round's feature slice feats_r [B, F] and
        counts_r [B]; ``merge`` is the hook of a split graph (None for one
        that is not).  Returns the host signal [B+2] u8, a static buffer
        that the next call rewrites."""
        self.feats.copy_(feats_r)
        self.counts.copy_(counts_r)
        if self.parts:
            self._replay(merge)
        elif not self.split:
            self._whole_body()
            if self.device.type == "cuda":
                self.parts = [capture(self._whole_body, self.device)[0]]
        else:
            self._finish_body(merged(self._search_body(), merge))
            if self.device.type == "cuda":
                self._capture_split()
        return self.host_sig

    def _capture_split(self) -> None:
        pre, rs = capture(self._search_body, self.device)
        self._search = rs
        self._slots = tuple(torch.empty_like(x) for x in rs.slots())
        post, _ = capture(
            lambda: self._finish_body(rs.with_slots(self._slots)),
            self.device, pool=pre.graph.pool())
        self.parts = [pre, post]

    def _replay(self, merge) -> None:
        if not self.split:
            self.parts[0].replay()
            return
        pre, post = self.parts
        pre.replay()
        for dst, src in zip(self._slots, merge(*self._search.slots())):
            dst.copy_(src)
        post.replay()

    def stats(self) -> dict:
        return _stats(self.name, self.parts)


class HeadGraph:
    """``rows_features`` of one head block shape, R rows of Cs samples, on
    static buffers.  ``run`` copies a block's n <= R rows in (rows of
    length 0 past them) and returns the block's features in the graph's
    static outputs, which its next run rewrites: ``batch_features`` copies
    them into the batch's own tensors at once, on the same stream."""

    def __init__(self, R: int, Cs: int, p, ed_cfg, compress_delta: float,
                 device):
        dev = torch.device(device)
        self.device = dev
        self.args = (p, ed_cfg, compress_delta)
        self.ins = (torch.zeros((R, Cs), dtype=torch.int32, device=dev),
                    torch.zeros(R, dtype=torch.float32, device=dev),
                    torch.ones(R, dtype=torch.float32, device=dev),
                    torch.zeros(R, dtype=torch.int32, device=dev))
        self.parts: list[Captured] = []
        self._out = None
        self.name = f"head rows={R} Cs={Cs}"

    def _body(self):
        return rows_features(*self.ins, *self.args)

    def run(self, q, qoff, qscale, clen):
        """(feats [R, F] f32, counts [R] i32) of the block's rows (as
        ``turbo.head_inputs`` gives them), on the current stream."""
        n = q.shape[0]
        for dst, src, pad in zip(self.ins, (q, qoff, qscale, clen),
                                 PAD_ROW):
            dst[:n].copy_(src)
            if n < dst.shape[0]:
                dst[n:].fill_(pad)
        if self.parts:
            self.parts[0].replay()
            return self._out
        out = self._body()
        if self.device.type == "cuda":
            part, self._out = capture(self._body, self.device)
            self.parts = [part]
        return out

    def stats(self) -> dict:
        return _stats(self.name, self.parts)
