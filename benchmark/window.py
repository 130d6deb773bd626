"""The measured window: a closed loop of ``streaming_map`` calls, and what
the run collected for the per-layer readers.

One caller hands the mapper one call's reads, waits for the records, and
hands it the next call's.  Calls take the pool's parts in turn, each in
its own order drawn from the seed, so no two consecutive calls carry the
same reads.  Calls go back to back until ``seconds`` have
passed; the call in flight then finishes and counts.

What the harness keeps of the calls (records and stamps, for the check and
the readers) is frozen out of Python's collector after each call
(``gc.freeze``), so the collections inside the window walk the objects
of the call in flight, as in a user's process that writes its records
out, and not every record of the window again.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import statistics
import time
from dataclasses import dataclass

from . import synthgen

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Call:
    t0: float                 # perf_counter at the call
    t1: float                 # perf_counter when its records were back
    part: int                 # pool part the reads came from
    order: list               # pool indices of the call's reads, in order
    records: list             # what streaming_map returned
    stamps: dict              # the mapper's last_pass for this call

    @property
    def n(self) -> int:
        return len(self.order)


@dataclass
class RunData:
    """What a run collected: the window's calls, the rescue counter's
    change, the mapper's CUDA graphs after the window
    (``TurboMapper.graph_stats()``), and the device trace of a traced run
    (None otherwise)."""

    calls: list
    rescued: int = 0
    graphs: list = None
    trace: object = None

    @property
    def window_s(self) -> float:
        """First timed call's start to the last call's end."""
        return self.calls[-1].t1 - self.calls[0].t0

    @property
    def attempted(self) -> int:
        return sum(c.n for c in self.calls)

    @property
    def completed(self) -> int:
        """Reads with a record, of the completed calls."""
        return sum(len(c.records) for c in self.calls)

    def walls(self) -> list:
        return [c.t1 - c.t0 for c in self.calls]


def drive(mapper, parts, seconds: float, seed: int, sync) -> RunData:
    """Calls back to back until ``seconds`` have passed since the first
    one started (``sync`` waits for the device after each call)."""
    rng = synthgen.rng_for(seed, "order")
    calls = []
    t_first = None
    i = 0
    while True:
        part = i % len(parts)
        order = rng.permutation(len(parts[part])).tolist()
        signals = [parts[part][j] for j in order]
        t0 = time.perf_counter()
        if t_first is None:
            t_first = t0
        records = mapper.streaming_map(signals)
        sync()
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, part, order, records, mapper.last_pass))
        gc.freeze()
        i += 1
        if t1 - t_first >= seconds:
            return RunData(calls)


def host_probe_ms(n: int = 300_000) -> float:
    """The ms of a fixed piece of single-threaded interpreter work (dict
    and integer operations): a witness of the host's speed beside a run,
    read before and after its window."""
    t = time.perf_counter()
    d = {}
    for k in range(n):
        d[k % 1024] = d.get(k % 1024, 0) + k * 3
    return (time.perf_counter() - t) * 1e3


# ---- end-to-end metrics (host clock) ---------------------------------------

def reads_per_s(run: RunData) -> float:
    """Records of every read of the completed calls, over the window."""
    return run.completed / run.window_s


def call_p95_s(run: RunData) -> float:
    """The 95th percentile of the calls' walls over all calls of the window
    (Python's ``statistics.quantiles``, inclusive: linear between the
    order statistics, never past the slowest call)."""
    w = run.walls()
    if len(w) < 2:
        return w[0]
    return statistics.quantiles(w, n=20, method="inclusive")[18]


# ---- per-layer readers ------------------------------------------------------

def load_reader(name: str, here: str = HERE):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
