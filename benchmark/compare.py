"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
window's reads drawn from the seed is re-mapped by the plain reference
(``reference``) from the same inputs: each read's pA, its DAC affine and
the reads of the batch it was mapped in.  The sample holds ``UNIFORM``
reads drawn from every completed call, and up to ``PER_ROUTE`` of the
reads the program sent to the rescue and up to ``PER_ROUTE`` whose
capacity overflowed.  For each sampled read the check compares:

* its record (every field but the read's position in its call and the
  ``mt:`` time tag) with the reference's: the head's features, the
  rounds' matches and chains, the stop rules and the output decision all
  reach it;
* whether its capacity overflowed (row 7 of the rounds' state);
* whether it went to the rescue;
* for up to ``RESCUE_RECORDS`` of the reads that the reference sends to
  the rescue, the rescue's record, re-mapped by the reference's exact
  engine.

Each is a count of sampled reads that differ, with the limit 0, beside
the window's reads that got no record, also with the limit 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import synthgen
from .reference import ReadIn, Reference, nc_bucket
from .reference.records import from_paf
from .reference.rescue import Undecided

UNIFORM = 48
PER_ROUTE = 6
RESCUE_RECORDS = 3


@dataclass
class Verdict:
    """Each number compared, its limit, and what the check saw."""

    numbers: dict = field(default_factory=dict)   # name -> (value, limit)
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())

    def lines(self) -> list:
        return self.notes + [f"compared: {k} = {v} (limit {lim})"
                             for k, (v, lim) in self.numbers.items()]

    def compared(self) -> dict:
        return {k: dict(value=v, limit=lim)
                for k, (v, lim) in self.numbers.items()}


@dataclass
class Sampled:
    read: ReadIn
    record: object            # the program's record as compared, or None
    overflow: bool
    rescued: bool


def draw_sample(run, seed: int) -> list:
    """(call, position) pairs: UNIFORM over the window's reads, then up to
    PER_ROUTE each of the program's rescued and overflowed reads."""
    rng = synthgen.rng_for(seed, "sample")
    all_pos = [(ci, p) for ci, c in enumerate(run.calls)
               for p in range(c.n)]
    picks = [all_pos[i] for i in rng.choice(
        len(all_pos), min(UNIFORM, len(all_pos)), replace=False)]
    for key in ("rescued", "overflow"):
        routed = [(ci, p) for ci, c in enumerate(run.calls)
                  for p in sorted(set(c.stamps.get(key) or []))
                  if (ci, p) not in picks]
        for i in rng.permutation(len(routed))[:PER_ROUTE]:
            picks.append(routed[int(i)])
    return picks


def sampled_reads(run, inputs, picks, read_batch: int, cfg) -> list:
    out = []
    for ci, pos in picks:
        c = run.calls[ci]
        part = inputs.pools[c.part]
        b0 = pos // read_batch * read_batch
        batch = [part[j][1] for j in c.order[b0: b0 + read_batch]]
        rid, pa = part[c.order[pos]]
        read = ReadIn(rid, pa, synthgen.DIGITISATION, synthgen.DAC_RANGE,
                      synthgen.DAC_OFFSET,
                      nc_bucket([len(x) for x in batch], cfg))
        rec = next((r for r in c.records if r.read_id == pos), None)
        out.append(Sampled(
            read, None if rec is None else from_paf(rec),
            pos in set(c.stamps.get("overflow") or []),
            pos in set(c.stamps.get("rescued") or [])))
    return out


def judge(ref: Reference, sample: list, failed: int, seed: int) -> Verdict:
    """Re-map the sample with ``ref`` and count what differs from the
    program's answers."""
    v = Verdict()
    outs = ref.map_rounds([s.read for s in sample])
    rec_diff = ovf_diff = route_diff = 0
    compared = rescue_done = undecided = 0
    rng = synthgen.rng_for(seed, "sample")
    to_rescue = [i for i, (_, _, resc) in enumerate(outs) if resc]
    rescue_pick = set(int(i) for i in
                      rng.permutation(to_rescue)[:RESCUE_RECORDS])
    for i, (s, (rec, ovf, resc)) in enumerate(zip(sample, outs)):
        ovf_diff += ovf != s.overflow
        route_diff += resc != s.rescued
        if resc:
            if i not in rescue_pick:
                continue
            try:
                rec = ref.rescue(s.read)
            except Undecided as e:
                undecided += 1
                v.notes.append(f"compared: {s.read.name} undecided: {e}")
                continue
            rescue_done += 1
        compared += 1
        if rec != s.record:
            rec_diff += 1
            if rec_diff <= 3:
                v.notes.append(f"compared: {s.read.name} differs: program "
                               f"{s.record} reference {rec}")
    v.notes.append(
        f"compared: {len(sample)} reads sampled, {compared} records "
        f"compared ({rescue_done} re-mapped by the rescue, {undecided} "
        f"undecided), {len(to_rescue)} sent to the rescue")
    v.notes.append("compared: reference seconds " + ", ".join(
        f"{k} {t:.3f}" for k, t in ref.seconds.items()))
    v.numbers = dict(records_differing=(rec_diff, 0),
                     overflow_differing=(ovf_diff, 0),
                     rescue_routing_differing=(route_diff, 0),
                     reads_failed=(failed, 0))
    return v


def check(cell, inputs, run, seed: int, dev) -> Verdict:
    """Build the reference of the run's genome on ``dev`` and judge the
    window's sample."""
    ref = Reference(inputs.genome, inputs.pore,
                    cell.config["turbo_params"], dev)
    sample = sampled_reads(run, inputs, draw_sample(run, seed),
                           cell.traffic["read_batch"], ref.cfg)
    failed = sum(c.n - len(c.records) for c in run.calls)
    return judge(ref, sample, failed, seed)
