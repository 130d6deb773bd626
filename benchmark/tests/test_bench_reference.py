"""The check on tiny inputs on the CPU: the port's mapper (its plain
PyTorch versions) against the reference, the reference's control, and a
run with the timed path broken underneath for each fault the cells can
have."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import compare, control, synthgen, window, workload
from benchmark.reference import Reference
from benchmark.tests.test_bench_generator import tiny_cell

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell(contigs=(("c1", 120_000),))
    cell.traffic = dict(cell.traffic, reads_per_call=12, read_batch=12,
                        off_target_share=0.25)
    inputs = workload.make_inputs(cell, SEED)
    ref = Reference(inputs.genome, inputs.pore, cell.config["turbo_params"],
                    "cpu")
    return cell, inputs, ref


def program_run(cell, inputs):
    """The window's first call through the port's mapper on the CPU."""
    from sigmap_tpu_torch.index.build import build_index
    from sigmap_tpu_torch.io.fasta import ReferenceSequence
    from sigmap_tpu_torch.io.pore_model import PoreModel
    from sigmap_tpu_torch.io.signals import ReadSignal
    from sigmap_tpu_torch.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu_torch.oracle import Oracle

    cfg = workload.sigmap_config(cell)
    lm = inputs.pore.level_mean
    z = np.zeros_like(lm)
    idx = build_index([ReferenceSequence(n, c) for n, c in inputs.genome],
                      PoreModel(inputs.pore.k, lm, z, z, z), cfg.index,
                      cfg.mapping.search_radius, verbose=False)
    mapper = TurboMapper(idx, cfg, TurboParams(**cell.config["turbo_params"]),
                         device="cpu", oracle=Oracle(idx, cfg))
    parts = [[ReadSignal(r, synthgen.DIGITISATION, synthgen.DAC_RANGE,
                         synthgen.DAC_OFFSET, pa) for r, pa in h]
             for h in inputs.pools]
    try:
        return window.drive(mapper, parts, 0.0, SEED, lambda: None)
    finally:
        mapper.close()


def verdict(cell, inputs, ref, run):
    sample = compare.sampled_reads(
        run, inputs, compare.draw_sample(run, SEED),
        cell.traffic["read_batch"], ref.cfg)
    failed = sum(c.n - len(c.records) for c in run.calls)
    return compare.judge(ref, sample, failed, SEED)


def test_the_port_agrees_with_the_reference(tiny):
    cell, inputs, ref = tiny
    run = program_run(cell, inputs)
    v = verdict(cell, inputs, ref, run)
    assert v.correct, v.lines()
    assert sum(len(c.stamps["rescued"]) for c in run.calls) > 0, \
        "the tiny cell must reach the rescue"


def test_the_control_fails(tiny):
    """The reference with its head in bfloat16 in the program's place,
    judged by the run's own comparison."""
    cell, inputs, ref = tiny
    v = control.control_verdict(cell, inputs, ref, SEED)
    assert not v.correct, v.lines()
    assert v.compared()["records_differing"]["value"] > 0


def _state_unchanged(monkeypatch):
    from sigmap_tpu_torch.mapping import turbo

    orig = turbo.turbo_round

    def stuck(store, feats, counts_r, n_full, st, *a, **k):
        _new, counts, host_sig = orig(store, feats, counts_r, n_full, st,
                                      *a, **k)
        return st, counts, host_sig

    monkeypatch.setattr(turbo, "turbo_round", stuck)


def _half_left_out(monkeypatch):
    from sigmap_tpu_torch.mapping.turbo import TurboMapper

    orig = TurboMapper.streaming_map

    def half(self, signals):
        return orig(self, signals[: len(signals) // 2])

    monkeypatch.setattr(TurboMapper, "streaming_map", half)


def _answer_altered(monkeypatch):
    from sigmap_tpu_torch.mapping.turbo import TurboMapper

    orig = TurboMapper._emit

    def altered(self, records, rid, *a, **k):
        orig(self, records, rid, *a, **k)
        rec = records[rid]
        if rec.is_mapped:
            records[rid] = dataclasses.replace(
                rec, fragment_start=rec.fragment_start + 1)

    monkeypatch.setattr(TurboMapper, "_emit", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny, fault, monkeypatch):
    cell, inputs, ref = tiny
    fault(monkeypatch)
    try:
        run = program_run(cell, inputs)
    except IndexError:
        return      # the run ends without a result: refused as well
    assert not verdict(cell, inputs, ref, run).correct


def test_reference_index_matches_the_port_on_a_small_genome(tiny):
    """The reference's own index holds the port's windows, values and
    metadata (a check of the stage the reference works out again)."""
    from sigmap_tpu_torch.index.build import build_index
    from sigmap_tpu_torch.io.fasta import ReferenceSequence
    from sigmap_tpu_torch.io.pore_model import PoreModel

    cell, inputs, ref = tiny
    cfg = workload.sigmap_config(cell)
    lm = inputs.pore.level_mean
    z = np.zeros_like(lm)
    idx = build_index([ReferenceSequence(n, c) for n, c in inputs.genome],
                      PoreModel(inputs.pore.k, lm, z, z, z), cfg.index,
                      cfg.mapping.search_radius, verbose=False)
    assert np.array_equal(idx.values, ref.idx.values.cpu().numpy())
    assert np.array_equal(idx.win_group, ref.idx.win_group.cpu().numpy())
    assert np.array_equal(idx.win_pos, ref.idx.win_pos.cpu().numpy())
    assert torch.equal(torch.from_numpy(idx.perm.astype(np.int64)),
                       ref.idx.perm.cpu().to(torch.int64))
