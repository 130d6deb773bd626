"""The port's exact engine (sigmap_tpu_torch.mapping.driver.Mapper) vs the
JAX Mapper on tests/test_mapping.py:20-38's setup (100 kb genome, 8 reads
of 1500 bases, read batch 8).

Read names, mapped flags, reference, strand, loci (fragment start and
length, read start and end), mapq, lengths and the ``ci:`` chunk index are
exact.  The rest differs only through f32 rounding: XLA's CPU backend
contracts the event-feature and distance arithmetic into fused
multiply-adds, the port rounds each f32 operation on its own (z-scored
features differ by ~3e-5, tests/test_torch_events.py), so

* chain scores (s1, s2, sm) agree within SCORE_RTOL (measured 2e-6);
* the anchor means ad, at, aq within AD_RTOL (measured 2e-5), except
* in batch mode a feature that close to the radius may gain or lose one
  anchor of the best chain (measured: one record, cm 315 vs 316); that
  record's anchor count agrees within 1 and its anchor means within
  ONE_ANCHOR_RTOL (measured 0.3%).
"""

import dataclasses

import pytest

from sigmap_tpu.config import RuntimeConfig, SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu.synth import simulate_reads
from sigmap_tpu_torch.mapping import driver as port

TEST_CFG = SigmapConfig(
    runtime=RuntimeConfig(
        read_batch=8, seeds_per_tile=32, cap_per_seed=8192,
        surv_per_tile=65536, matches_per_tile=16384,
    )
)
SCORE_RTOL = 1e-5
AD_RTOL = 3e-4
ONE_ANCHOR_RTOL = 1e-2


@pytest.fixture(scope="module")
def setup(pore6, tiny_genome):
    seqs = [ReferenceSequence(n, c) for n, c in tiny_genome]
    idx = build_index(seqs, pore6, TEST_CFG.index, verbose=False)
    reads = simulate_reads(pore6, tiny_genome, 8, seed=21, read_bases=1500)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    return idx, reads, signals


def _tags(rec):
    return {t.split(":", 1)[0]: t.split(":", 2)[1:]
            for t in rec.tags.split("\t")}


def _compare(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        gt, wt = _tags(g), _tags(w)
        gd.pop("tags"), wd.pop("tags")
        assert gd == wd, (gd, wd)
        assert gt.keys() == wt.keys()
        one_anchor = "cm" in gt and gt["cm"] != wt["cm"]
        if one_anchor:
            assert abs(int(gt["cm"][1]) - int(wt["cm"][1])) == 1
        for k, (kind, gv) in gt.items():
            wv = wt[k][1]
            if k in ("mt", "cm"):
                continue
            if kind == "f":
                rtol = (SCORE_RTOL if k in ("s1", "s2", "sm") else
                        ONE_ANCHOR_RTOL if one_anchor else AD_RTOL)
                assert abs(float(gv) - float(wv)) <= \
                    rtol * abs(float(wv)) + 2e-6, (g.read_name, k, gv, wv)
            else:
                assert gv == wv, (g.read_name, k, gv, wv)


@pytest.mark.parametrize("mode", ["streaming_map", "map_reads"])
def test_mapper_matches_jax(setup, mode):
    from sigmap_tpu.mapping.driver import Mapper

    idx, reads, signals = setup
    got = getattr(port.Mapper(idx, TEST_CFG, device="cpu"), mode)(signals)
    want = getattr(Mapper(idx, TEST_CFG), mode)(signals)
    _compare(got, want)
    assert sum(r.is_mapped for r in got) >= len(signals) - 1


def test_num_threads_parity(setup):
    """-t 3 chains reads on a thread pool and gives -t 1's records."""
    idx, _, signals = setup
    recs = []
    for t in (1, 3):
        cfg = dataclasses.replace(TEST_CFG, runtime=dataclasses.replace(
            TEST_CFG.runtime, num_threads=t))
        recs.append(port.Mapper(idx, cfg, device="cpu").streaming_map(
            signals))
    for a, b in zip(*recs):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        a["tags"] = [t for t in a["tags"].split("\t") if t[:2] != "mt"]
        b["tags"] = [t for t in b["tags"].split("\t") if t[:2] != "mt"]
        assert a == b
