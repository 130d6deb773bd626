"""The turbo mapper's span record: where a ``streaming_map`` pass spent its
host time, at the boundaries of its layers.

A pass's record (``new_pass``, kept as ``TurboMapper.last_pass``) is a dict.
Besides the legacy stamps that readers of earlier versions use (``start``,
each batch's ``rounds``, each round's ``round_host``, the ``rescues``
drain, and the ``overflow`` and ``rescued`` reads), it holds ``pass_id``,
the mapper's count of its passes, and ``spans``: one ``Span`` for each
piece of work, with its start and end on ``time.perf_counter()``, the
index of its parent span, its batch and its thread's name.  Span 0 is the
pass's ``map.pass``.  The names, and their parents:

    map.pass          the whole call                           -
    head.stage        stage_batch: pA into the pinned buffer   map.pass
    head.quantize     the upload and quantize (its read-back)  map.pass
    head.features     batch_features' blocks, the batch event  map.pass
    head.wait         the caller waiting for a prepared batch  map.pass
    round.loop        a batch's round loop                     map.pass
    round.launch      a round's work sent                      round.loop
    round.signal      its host signal back and handled         round.loop
    round.epilogue    the last signal to the batch's last      map.pass
                      record: state downloads, records, rescue
                      submissions
    rescue.read       one rescued read's exact-engine run on   round.epilogue
                      its pool thread; number ``cpu_s``, its
                      thread's CPU time
    rescue.search     one chunk's radius search of a rescued   rescue.read
                      read; numbers ``device`` (1 on the card,
                      0 on the k-d tree), ``seeds``, ``matches``,
                      ``past_cap`` (its queries whose answer
                      holds ``per_cap`` matches: the tree cut
                      them there, and the card left them to it)
    rescue.drain      the wait for the pass's rescued reads    map.pass

The set-up builds are spans outside any pass (``setup_span``), kept by
what they built, with no parent, batch or pass: ``setup.index`` (the
``SignalIndex``'s ``build_span``, ``index/build.py:build_index``),
``setup.tree`` (the ``Oracle``'s ``build_span``, its k-d tree) and
``setup.tile_store`` (the mapper's tile store).  Every pass's record
carries the mapper's as a list, ``build``, in that order and without the
tree while the oracle is not built, and the counter ``store_bytes``: the
bytes of the tile store on the device (tiles, meta, cell table, rotation,
mean and origin; the cell sort's permutation and the index's values, which
the rescue reads, stay on the host).

A child lies inside its parent, but for ``rescue.read``: a rescued read
is submitted inside its batch's epilogue and runs on a rescue thread when
one is free, before the pass's drain ends.  Spans are always recorded:
two clock reads and an append each.  While a torch profiler records
(decided once a pass, on the caller's thread), each span also runs inside
``torch.profiler.record_function(name)``, which puts it on the
profiler's clock, in its trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

PASS = 0                 # the index of a pass's map.pass span

# one lock for every pass record: a span's index is its position in its
# pass's list, and spans are appended from the caller, the prepare thread
# and the rescue threads
_append = threading.Lock()


@dataclass(eq=False, slots=True)
class Span:
    """One piece of a pass's work, named as in the table above."""

    name: str
    t0: float                       # perf_counter s
    t1: float | None = None         # None while open
    parent: int | None = None       # index of the parent span in the pass
    batch: int | None = None        # the batch's index in the pass
    thread: str = ""
    pass_id: int | None = None
    index: int = -1                 # its own index in the pass
    numbers: dict = field(default_factory=dict)

    @property
    def s(self) -> float:
        return self.t1 - self.t0

    def close(self, t1: float | None = None):
        """End the span now (or at ``t1``), before its ``with`` ends."""
        self.t1 = time.perf_counter() if t1 is None else t1


def profiler_recording() -> bool:
    """Whether a torch profiler records.  ``_profiler_enabled()`` reads
    False on every thread while a profiler records all threads
    (``profile_all_threads``); the flag the profiler sets in
    ``torch.autograd.profiler`` reads True in both cases."""
    return (torch.autograd._profiler_enabled()
            or torch.autograd.profiler._is_profiler_enabled)


@contextlib.contextmanager
def setup_span(name: str):
    """Record the work of the ``with`` body as the set-up span ``name``,
    kept by its caller; inside ``record_function(name)`` while a torch
    profiler records.  Yields the ``Span``."""
    sp = Span(name, time.perf_counter(),
              thread=threading.current_thread().name)
    try:
        if profiler_recording():
            with torch.profiler.record_function(name):
                yield sp
        else:
            yield sp
    finally:
        if sp.t1 is None:
            sp.close()


def new_pass(pass_id: int) -> dict:
    """A pass's record, started now."""
    return dict(pass_id=pass_id, start=time.perf_counter(),
                mirror=profiler_recording(), spans=[], rounds=[],
                round_host=[], rescues=None, overflow=[], rescued=[])


@contextlib.contextmanager
def span(stamps: dict | None, name: str, parent: int | None = PASS,
         batch: int | None = None, t0: float | None = None):
    """Record the work of the ``with`` body as a span ``name`` of the pass
    ``stamps``, started at ``t0`` (a boundary another span already read)
    or now, ended when the body ends unless it closed the span itself.
    Yields the ``Span``.  With ``stamps`` None (a call outside a pass) the
    span is kept nowhere."""
    sp = Span(name, time.perf_counter() if t0 is None else t0,
              parent=parent, batch=batch,
              thread=threading.current_thread().name)
    mirror = False
    if stamps is not None:
        sp.pass_id, mirror = stamps["pass_id"], stamps["mirror"]
        spans = stamps["spans"]
        with _append:
            sp.index = len(spans)
            spans.append(sp)
    try:
        if mirror:
            with torch.profiler.record_function(name):
                yield sp
        else:
            yield sp
    finally:
        if sp.t1 is None:
            sp.close()
