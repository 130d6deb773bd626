"""The port's debug modes (sigmap_tpu_torch.debug_modes) vs the JAX
package's, on tests/test_debug_modes.py's workload with 3 reads and a
2-sequence genome, so the sDTW pairs are ragged.

Everything is compared exactly: returned tuples, the text printed to the
stream, and the dumped files byte for byte.  The port's sDTW (B5's plain
version on the CPU) computes the reference's recurrence with the same f32
rounding, and its events-to-text dump runs a numpy copy of the same
``events_ref`` functions.
"""

import io

import numpy as np
import pytest

from sigmap_tpu import debug_modes as jdm
from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.io.fast5 import write_multi_fast5
from sigmap_tpu.io.signals import load_all_read_signals
from sigmap_tpu.signal import events_ref as jref
from sigmap_tpu.synth import genome_to_fasta_str, random_genome, simulate_reads
from sigmap_tpu_torch import debug_modes as tdm
from sigmap_tpu_torch.signal import events_ref as tref

SMS = 132                  # an H100 SXM's SMs (the plan's `sms`)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    from sigmap_tpu.io.pore_model import make_synthetic_pore_model

    tmp = tmp_path_factory.mktemp("debug")
    pore = make_synthetic_pore_model(k=6, seed=0)
    g0, g1 = random_genome(420, seed=31, n_seqs=2)
    genome = [g0, (g1[0], g1[1][:300])]      # references of two lengths
    (tmp / "ref.fa").write_text(genome_to_fasta_str(genome))
    pore.save(str(tmp / "pore.model"))
    reads = simulate_reads(pore, genome, 3, seed=32, read_bases=60)
    sig = tmp / "sigs"
    sig.mkdir()
    write_multi_fast5(str(sig / "r.fast5"), [r.__dict__ for r in reads])
    return str(tmp / "ref.fa"), str(tmp / "pore.model"), str(sig), tmp


@pytest.mark.parametrize("mode", ["dtw_align", "cwt_align"])
def test_align_modes_match_jax(work, mode):
    ref, pore, sig, _ = work
    j_out, t_out = io.StringIO(), io.StringIO()
    want = getattr(jdm, mode)(ref, pore, sig, out=j_out)
    got = getattr(tdm, mode)(ref, pore, sig, out=t_out, device="cpu")
    assert len(got) == 6                     # 3 reads x 2 references
    assert got == want
    assert t_out.getvalue() == j_out.getvalue()


def test_pairs_are_ragged(work):
    ref, pore, sig, _ = work
    labels, targets, queries = tdm.dtw_pairs(ref, pore, sig)
    assert [lab[1] for lab in labels[:2]] == ["synth_0", "synth_1"]
    assert len({len(q) for q in queries}) == 3
    assert len({len(t) for t in targets}) == 2
    t, t_len, q, q_len = tdm.pack_pairs(targets, queries, "cpu")
    assert t.shape == (6, max(map(len, targets)))
    assert q_len.tolist() == [len(x) for x in queries]


def test_batch_bounds_split_at_the_budget():
    targets = [np.zeros(n, np.float32) for n in (10, 30, 20, 5)]
    queries = [np.zeros(4, np.float32)] * 4
    assert tdm.batch_bounds(targets, queries, SMS) == [(0, 4)]
    # 4 * (30 + 4) bytes a pair once the 30-sample target is in; one pass,
    # so no scratch
    assert tdm.batch_bytes(2, 30, 4, SMS) == 4 * 34 * 2
    assert tdm.batch_bounds(targets, queries, SMS, budget=4 * 34 * 2) == [
        (0, 2), (2, 4)]
    assert tdm.batch_bounds(targets, queries, SMS, budget=1) == [
        (0, 1), (1, 2), (2, 3), (3, 4)]


def test_batch_bounds_count_the_plan_scratch():
    """A query longer than a cluster's rows runs in passes; the [n, T]
    scratch row that plan allocates then counts against the budget."""
    from sigmap_tpu_torch.ops.sdtw_kernel import plan

    T, Q = 1000, 200_000
    pl = plan(2, T, Q, SMS)
    assert pl.passes > 1 and pl.scratch_bytes == 4 * 2 * T
    assert tdm.batch_bytes(2, T, Q, SMS) == 4 * (T + Q) * 2 + 4 * 2 * T
    targets = [np.empty(T, np.float32)] * 3
    queries = [np.empty(Q, np.float32)] * 3
    budget = tdm.batch_bytes(2, T, Q, SMS)
    assert budget < tdm.batch_bytes(3, T, Q, SMS)
    assert tdm.batch_bounds(targets, queries, SMS, budget=budget) == [
        (0, 2), (2, 3)]
    # the inputs of two pairs alone fit this budget; with the scratch they
    # do not
    assert tdm.batch_bounds(targets, queries, SMS,
                            budget=4 * (T + Q) * 2) == [(0, 1), (1, 2),
                                                        (2, 3)]


@pytest.mark.parametrize("mode", ["fast5_to_text", "events_to_text"])
def test_dumps_are_byte_identical(work, mode):
    _, _, sig, tmp = work
    pj = getattr(jdm, mode)(sig, str(tmp / "jax"))
    pt = getattr(tdm, mode)(sig, str(tmp / "port"))
    data = open(pt, "rb").read()
    assert data == open(pj, "rb").read()
    assert data.count(b"\n") > 20


def test_events_ref_equals_jax(work):
    _, _, sig, _ = work
    ev = SigmapConfig().event
    for s in load_all_read_signals(sig):
        L = len(s.pa)
        for a, b in zip(tref.prefix_sums(s.pa), jref.prefix_sums(s.pa)):
            np.testing.assert_array_equal(a, b)
        for w in (ev.window_length1, ev.window_length2):
            np.testing.assert_array_equal(tref.tstat_centered(s.pa, L, w),
                                          jref.tstat_centered(s.pa, L, w))
        t1 = jref.tstat_centered(s.pa, L, ev.window_length1)
        t2 = jref.tstat_centered(s.pa, L, ev.window_length2)
        peaks = jref.detect_peaks(t1, t2, L, ev)
        assert tref.detect_peaks(t1, t2, L, ev) == peaks
        ps, pss = jref.prefix_sums(s.pa)
        for sig_arg in (None, s.pa):
            for a, b in zip(
                    tref.events_from_peaks(peaks, ps, pss, L, signal=sig_arg),
                    jref.events_from_peaks(peaks, ps, pss, L, signal=sig_arg)):
                np.testing.assert_array_equal(a, b)
        means = jref.events_from_peaks(peaks, ps, pss, L, signal=s.pa)[1]
        np.testing.assert_array_equal(tref.zscore(means), jref.zscore(means))


@pytest.mark.parametrize("w", [2, 3, 6, 14, 130])
def test_tstat_centered_equals_jax_at_window_widths(w):
    """numpy's ndarray.sum adds a window sequentially below 8 values and
    pairwise above, so widths on both sides (and past numpy's 128-value
    block) are held exact."""
    x = np.random.default_rng(w).normal(90, 12, 3000).astype(np.float32)
    np.testing.assert_array_equal(tref.tstat_centered(x, len(x), w),
                                  jref.tstat_centered(x, len(x), w))


def test_empty_pairs_answer_like_sdtw_np():
    from sigmap_tpu.ops.sdtw import sdtw_np

    t = np.arange(5, dtype=np.float32)
    e = np.zeros(0, np.float32)
    best, end = tdm.sdtw_pairs([t, e, t], [e, t, t], "cpu")
    for k, (tt, qq) in enumerate([(t, e), (e, t), (t, t)]):
        nb, ne = sdtw_np(tt, qq)
        assert (float(best[k]), int(end[k])) == (float(np.float32(nb)), ne)
