"""The turbo mapper's graphs (sigmap_tpu_torch/mapping/graphs.py) on the
CPU, where nothing is captured and every call runs the graphs' static-buffer
code eagerly, on the 200 kb workload of tests/test_turbo.py (B=32, S=256,
K=16, RING=64, TILE=256).

* RoundGraph, carried through a batch's rounds on its own static state, as
  one graph and split around an identity merge hook, equals the eager
  turbo_round exactly, and is held to the JAX package's turbo_round as
  tests/test_torch_round.py holds the port's round: integers exact, f32 to
  RTOL, a read differing only where one of its seeds has a window within
  EPS of the radius.
* The head runs in row blocks, one head graph a block shape: a batch's
  outputs are its own (a later batch of the same or another bucket does
  not overwrite them), and batches of three chunk buckets leave one graph
  a block shape, whatever B and NC are.
* The mapper keys its graphs on what fixes their shapes and constants, and
  streaming_map through the graphs gives the eager path's records apart
  from mt:.

On the card tests/test_torch_gpu.py holds the captured graphs to the eager
path (chip_smoke.py phases 4, 5, 8, 10 and 11 too).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sigmap_tpu.index.sweep import SweepIndex
from sigmap_tpu_torch.mapping import turbo as port
from sigmap_tpu_torch.mapping.graphs import HeadGraph, RoundGraph
from _torch_util import (  # noqa: F401 - fixtures
    MIXED_CAP, PARAMS, mixed_workload, workload,
)
from test_torch_round import RTOL, _boundary_reads


def _identity(*slots):
    return slots


def _states_equal(a: port.RoundState, b: port.RoundState) -> bool:
    fields = ("chunk_idx", "done", "stopped", "offsets", "rb_f", "rb_i")
    return (all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
            and all(torch.equal(x, y) for x, y in zip(a.carry, b.carry)))


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_round_graph_matches_eager_and_jax(workload, split):
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    cfg, idx, _, signals = workload
    m = cfg.mapping
    B = cfg.runtime.read_batch
    jm = TurboMapper(idx, cfg, TurboParams(peaks_impl="scan", **PARAMS))
    feats_all, counts_all, n_full_d, n_full, _NC = jm._prepare_batch(
        signals[:B])
    p = port.TurboParams(**PARAMS)
    store = port.tile_store_from_sweep(
        SweepIndex.build(idx, m.search_radius, tile=p.TILE), "cpu")
    args = (p, m.step_size, m.search_radius, idx.dim, cfg.chain, m)
    nf = torch.from_numpy(np.asarray(n_full, np.int32))
    F = np.asarray(feats_all).shape[-1]
    graph = RoundGraph((store, *args), B, F, "cpu", split=split)
    graph.start(nf)
    st = port.init_round_state(B, p.RING, "cpu")
    state = jm._init_state(B)
    merge = _identity if split else None
    differ, explained = set(), set()
    rounds = 0
    done = n_full == 0
    while not done.all():
        feats_r, counts_r = (torch.from_numpy(np.asarray(x)) for x in
                             jm._slice_chunk(feats_all, counts_all,
                                             np.int32(rounds)))
        offsets = graph.state.offsets.numpy().copy()
        sig = graph.run(feats_r, counts_r, merge)
        st, counts, want_sig = port.turbo_round(
            store, feats_r, counts_r, nf, st, p, *args[1:])
        # the static-buffer path is the eager round, bit for bit
        assert _states_equal(graph.state, st)
        assert torch.equal(sig, want_sig)
        out = jm._run_round(np.asarray(feats_r), np.asarray(counts_r),
                            n_full_d, *state)
        got = graph.state
        w_carry = [np.asarray(c) for c in out[4]]
        ints = [(got.chunk_idx, out[0]), (got.done, out[1]),
                (got.stopped, out[2]), (got.offsets, out[3]),
                (got.rb_i, out[6])] + [(got.carry[k], w_carry[k])
                                       for k in (0, 1, 2, 4, 5, 6)]
        bad = np.zeros(B, bool)
        for g, w in ints:
            bad |= (g.numpy() != np.asarray(w)).reshape(-1, B).any(axis=0)
        for g, w in ((got.rb_f, out[5]), (got.carry[3], w_carry[3]),
                     (got.carry[7], w_carry[7])):
            g, w = g.numpy(), np.asarray(w)
            close = np.abs(g - w) <= RTOL * np.abs(w) + RTOL
            bad |= ~close.reshape(-1, B).all(axis=0)
        np.testing.assert_array_equal(sig.numpy()[B:], np.asarray(out[9])[B:])
        # a read that differs first in this round must have a seed at the
        # radius's boundary here; once apart, the two runs carry it apart
        new = sorted(set(np.nonzero(bad)[0].tolist()) - differ)
        if new:
            differ |= set(new)
            explained |= _boundary_reads(idx, feats_r.numpy(),
                                         counts.numpy(), offsets, p, m, new)
        state = out[:7]
        done = np.asarray(out[1])
        rounds += 1
    assert rounds >= 2
    assert differ <= explained, f"reads {sorted(differ - explained)} differ"
    assert len(differ) <= 0.01 * B


def test_head_graphs_keep_a_batch_that_is_still_read(workload):
    """Batches of two (B, NC) buckets in turn, A1, B, A2, through head
    graphs of 4-row blocks (A: one block, B: two): each run returns
    batch_features of its own inputs, and A1's outputs, still held, are
    neither rewritten nor shared by the later runs or the graphs."""
    cfg, _, _, _ = workload
    p = port.TurboParams(**PARAMS)
    args = (p, cfg.event, cfg.mapping.compress_delta)
    rng = np.random.default_rng(0)
    B, Cs = 4, 4000
    graphs: dict = {}

    def run_block(size, part):
        g = graphs.setdefault(size, HeadGraph(size, Cs, *args, "cpu"))
        return g.run(*part)

    def batch(NC):
        q = torch.from_numpy(
            rng.integers(20000, 40000, (B, NC, Cs)).astype(np.int32))
        qoff = torch.from_numpy(rng.uniform(-2000, 0, B).astype(np.float32))
        qscale = torch.full((B,), 0.1, dtype=torch.float32)
        n_full = torch.from_numpy(rng.integers(0, NC + 1, B).astype(np.int32))
        return q, qoff, qscale, n_full

    runs = []
    for NC in (1, 2, 1):
        ins = batch(NC)
        out = port.batch_features(*ins, *args, block=4, run_block=run_block)
        want = port.batch_features(*ins, *args, block=B * NC)
        for g, w in zip(out, want):
            # exactly (a read with no chunk has NaN features, as in the
            # JAX package)
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        runs.append((out, tuple(t.clone() for t in out)))
    assert list(graphs) == [4]
    (first, kept), _, (last, _) = runs
    for t, k in zip(first, kept):
        torch.testing.assert_close(t, k, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(first, last):
        assert a.data_ptr() != b.data_ptr()
    g = graphs[4]
    static = [t.data_ptr() for t in g.ins]
    static += [t.data_ptr() for t in g._out or ()]
    assert all(t.data_ptr() not in static for t in first)


def test_graph_key_change_makes_a_new_graph(workload):
    """A mapper keeps one graph per key and makes a new one when anything
    that fixes its shapes or constants changes: the batch shape, the
    TurboParams, a merge hook (the round in two graphs), the chunk
    bucket."""
    cfg, idx, _, _ = workload
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                              device="cpu")
    try:
        assert not mapper._graphs      # the CPU runs eagerly by default
        g = mapper._round_graph(32, 1024)
        assert mapper._round_graph(32, 1024) is g and not g.split
        assert mapper._round_graph(16, 1024) is not g
        mapper.p = dataclasses.replace(mapper.p, RING=32)
        g2 = mapper._round_graph(32, 1024)
        assert g2 is not g and g2.state.carry[0].shape == (32, 32)
        mapper._merge_matches = _identity
        assert mapper._round_graph(32, 1024).split
        h = mapper._head_graph(64, 4000)
        assert mapper._head_graph(64, 4000) is h
        assert mapper._head_graph(32, 4000) is not h
        assert h.ins[0].shape == (64, 4000)
        assert len(mapper.graph_stats()) == 6
        assert all(s["captures"] == 0 and s["replays"] == 0
                   for s in mapper.graph_stats())
    finally:
        mapper.close()


def test_head_graphs_are_one_per_block_shape(mixed_workload):
    """Batches of three chunk buckets (NC 1, 2 and 3 at read batch 4, the
    mixed workload's on-target reads) in head blocks of 8 rows (rows 4, 8,
    12: blocks of 4; 8; 8 and 4) through the graphs' static buffers leave
    one head graph a block shape, whatever the bucket, with the eager
    path's records apart from mt:."""
    cfg, idx, _, signals = mixed_workload
    Cs = cfg.mapping.chunk_size
    by_nc = {nc: [s for s in signals if s.read_id.startswith("read_")
                  and min(s.length // Cs, MIXED_CAP) == nc][:4]
             for nc in (1, 2, MIXED_CAP)}
    batches = [s for nc in (1, 2, MIXED_CAP) for s in by_nc[nc]]
    assert all(len(b) == 4 for b in by_nc.values())
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, read_batch=4))
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                              device="cpu")
    mapper._head_block = 8
    try:
        eager = mapper.streaming_map(batches)
        mapper._graphs = True
        graphs = mapper.streaming_map(batches)
        stats = mapper.graph_stats()
    finally:
        mapper.close()
    assert _without_mt(graphs) == _without_mt(eager)
    heads = [s for s in stats if s["graph"].startswith("head")]
    assert sorted(s["graph"] for s in heads) == [f"head rows=4 Cs={Cs}",
                                                 f"head rows=8 Cs={Cs}"]


def _without_mt(recs):
    return [dataclasses.replace(r, tags="\t".join(
        t for t in r.tags.split("\t") if not t.startswith("mt:")))
        for r in recs]


def test_streaming_map_through_graphs_equals_eager(workload):
    """streaming_map with every round and head through the graphs' static
    buffers gives the eager path's records, floats exactly, apart from
    mt: (four batches, so a graph serves several batches)."""
    cfg, idx, _, signals = workload
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                              device="cpu")
    try:
        eager = mapper.streaming_map(signals)
        mapper._graphs = True
        graphs = mapper.streaming_map(signals)
        names = [s["graph"] for s in mapper.graph_stats()]
        assert names[0] == "round B=32 F=1024"
        assert len(names) == 1 + len(mapper._head_graphs) >= 2
    finally:
        mapper.close()
    assert len(graphs) == len(signals)
    assert _without_mt(graphs) == _without_mt(eager)
    assert len(mapper.last_pass["round_host"]) >= 4
    assert all(0 <= a <= b for a, b in mapper.last_pass["round_host"])
