"""The traced run's device trace: torch.profiler's chrome trace reduced to
device busy time, device time by kernel name and the host's work in the
device's idle gaps.

``union``, ``device_busy`` and ``host_gaps`` are frozen copies of
``chip_smoke.py``'s ``_union``, ``device_busy`` and ``host_gaps``, taking
the trace's events rather than a file path.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

# chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")


def union(spans):
    """Sorted disjoint intervals covering the (start, end) pairs."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy(events):
    """(busy ms, {name: (ms, count)}) of the device work among chrome-trace
    ``events``; busy time is the union of the intervals, so overlap counts
    once."""
    ev = [e for e in events if e.get("ph") == "X"
          and e.get("cat") in DEVICE_CATS]
    busy = sum(b - a for a, b in union((e["ts"], e["ts"] + e["dur"])
                                       for e in ev))
    by_name: dict = {}
    for e in ev:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1000, n + 1)
    return busy / 1000, by_name


def host_gaps(events, top=10):
    """Where the device waits: the gaps between device intervals (kernel,
    memcpy, memset; overlapping intervals merged), with the stretch before
    the first interval and the one after the last.  Returns the number of
    gaps, their sum, the host ops (torch.profiler CPU ops and CUDA runtime
    calls; nested ops each count, so they overlap) by the time they ran
    inside any gap, and the ``top`` longest gaps with their three longest
    host ops and the share of the gap in which any such op ran."""
    ev = [e for e in events if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e.get("cat") in DEVICE_CATS)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
            if e.get("cat") in HOST_CATS]
    t0 = min(e["ts"] for e in ev)
    t1 = max(e["ts"] + e["dur"] for e in ev)
    gaps, end, last = [], t0, "(start of the window)"
    for a, b, name in dev + [(t1, t1, "(end of the window)")]:
        if a > end:
            gaps.append((end, a, last, name))
        if b > end:
            end, last = b, name
    starts = [g[0] for g in gaps]
    per_gap = [[] for _ in gaps]
    for a, b, name in host:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(gaps) and gaps[i][0] < b:
            lo, hi = max(a, gaps[i][0]), min(b, gaps[i][1])
            if hi > lo:
                per_gap[i].append((lo, hi, name))
            i += 1
    all_ops: dict = {}
    for spans in per_gap:
        for lo, hi, name in spans:
            all_ops[name] = all_ops.get(name, 0.0) + (hi - lo)
    out = []
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    for i in order[:top]:
        g0, g1, before, after = gaps[i]
        by_op: dict = {}
        covered, e0 = 0.0, g0
        for lo, hi, name in sorted(per_gap[i]):
            by_op[name] = by_op.get(name, 0.0) + (hi - lo)
            if hi > e0:
                covered += hi - max(lo, e0)
                e0 = hi
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:3]
        out.append(dict(gap_ms=(g1 - g0) / 1000, after=before[:60],
                        before=after[:60],
                        host_ops=[(n[:60], t / 1000) for n, t in ops],
                        host_op_share=covered / (g1 - g0)))
    return dict(
        n_gaps=len(gaps), gap_ms=sum(b - a for a, b, _, _ in gaps) / 1000,
        host_ops=[(n[:60], t / 1000) for n, t in
                  sorted(all_ops.items(), key=lambda kv: -kv[1])[:top]],
        longest=out)


@dataclass
class DeviceTrace:
    """What the traced window's device trace holds: busy seconds, device
    seconds and counts by kernel name, and the host ops in the idle gaps
    (``host_gaps``)."""

    busy_s: float
    by_name: dict = field(default_factory=dict)   # name -> (s, count)
    gaps: dict = field(default_factory=dict)

    def seconds_of(self, symbol: str):
        """Device seconds of the kernels whose demangled name holds
        ``symbol`` followed by its template or argument list (graph replays
        included), or None when the trace has none."""
        hits = [s for name, (s, _) in self.by_name.items()
                if f"{symbol}<" in name or f"{symbol}(" in name]
        return sum(hits) if hits else None

    def breakdown(self, top: int = 10) -> dict:
        """The result's ``breakdown``: the device operations that took most
        time, and the longest idle gaps, each named by the host op that ran
        longest inside it and the device op it follows."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = []
        for g in self.gaps.get("longest", [])[:top]:
            host = g["host_ops"][0][0] if g["host_ops"] else "no host op"
            gaps.append([f"{host} (after {g['after'][:40]})",
                         g["gap_ms"] / 1000])
        return dict(device_ops=[[name[:120], s] for name, (s, _) in ops],
                    idle_gaps=gaps)


def reduce_profile(prof) -> DeviceTrace:
    """A finished torch.profiler.profile -> DeviceTrace.  The chrome trace
    goes to a file under the run's temporary directory only for as long
    as it is read."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    busy_ms, by_name = device_busy(events)
    return DeviceTrace(
        busy_s=busy_ms / 1000,
        by_name={k: (ms / 1000, n) for k, (ms, n) in by_name.items()},
        gaps=host_gaps(events))
