"""Accuracy/latency evaluation of annotated PAF output.

Parity with the reference's offline scorer (eval/eval.py): consumes PAF
lines whose LAST tag carries a pafstats-style classification (tp/fp/fn/tn),
prints precision / recall / F1 and mean/median mapping time per read and
per chunk from the in-band mt:/ci: tags (eval/eval.py:56-111).

Also provides a simulation-truth scorer for synthetic workloads (no
pafstats needed): a mapping is TP if it overlaps the simulated origin on
the correct strand.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from statistics import mean, median


@dataclass
class EvalResult:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    tn: int = 0
    time_per_read: list = None
    time_per_chunk: list = None

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0


def _tagmap(cols):
    out = {}
    for c in cols[12:]:
        parts = c.split(":", 2)
        if len(parts) == 3:
            out[parts[0]] = parts[2]
    return out


def evaluate_annotated_paf(path: str, out=sys.stderr) -> EvalResult:
    """Score a pafstats-annotated PAF (classification in the last tag),
    mirroring eval/eval.py:56-111."""
    res = EvalResult(time_per_read=[], time_per_chunk=[])
    with open(path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 13:
                continue
            tags = _tagmap(cols)
            cls = cols[-1].split(":")[-1]
            mt = float(tags.get("mt", "0"))
            if cls != "na":
                res.time_per_read.append(mt)
            if cls in ("tp", "fp", "fn", "tn"):
                setattr(res, cls, getattr(res, cls) + 1)
                if "ci" in tags and cls in ("tp", "fp", "fn", "tn"):
                    res.time_per_chunk.append(mt / max(1, int(tags["ci"])))
    _report(res, out)
    return res


def evaluate_against_truth(records, reads, ref_names=None,
                           out=sys.stderr) -> EvalResult:
    """Score PAFRecords against sigmap_tpu_torch.synth.SimulatedRead truth."""
    res = EvalResult(time_per_read=[], time_per_chunk=[])
    by_name = {r.read_name: r for r in records}
    for sim in reads:
        rec = by_name.get(sim.read_id)
        if rec is None:
            res.fn += 1
            continue
        tags = dict(
            t.split(":", 2)[::2] for t in rec.tags.split("\t") if ":" in t
        )
        mt = float(rec.tags.split("mt:f:")[1].split("\t")[0]) if "mt:f:" in rec.tags else 0.0
        res.time_per_read.append(mt)
        if "ci:i:" in rec.tags:
            ci = int(rec.tags.split("ci:i:")[1].split("\t")[0])
            res.time_per_chunk.append(mt / max(1, ci))
        if not rec.is_mapped:
            res.fn += 1
            continue
        lo = rec.fragment_start
        hi = rec.fragment_start + rec.fragment_length
        ok = (
            rec.direction == sim.strand
            and lo < sim.ref_end
            and hi > sim.ref_start
        )
        if ok:
            res.tp += 1
        else:
            res.fp += 1
    _report(res, out)
    return res


def _report(res: EvalResult, out):
    print(f"TP: {res.tp}\nFP: {res.fp}\nFN: {res.fn}\nTN: {res.tn}", file=out)
    print(f"precision: {res.precision}", file=out)
    print(f"recall: {res.recall}", file=out)
    print(f"F-1 score: {res.f1}", file=out)
    if res.time_per_read:
        print(f"Mean time per read : {mean(res.time_per_read)}", file=out)
        print(f"Median time per read : {median(res.time_per_read)}", file=out)
    if res.time_per_chunk:
        print(f"Mean time per chunk : {mean(res.time_per_chunk)}", file=out)
        print(f"Median time per chunk : {median(res.time_per_chunk)}", file=out)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m sigmap_tpu_torch.evaluate annotated.paf", file=sys.stderr)
        return 1
    evaluate_annotated_paf(argv[0], out=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
