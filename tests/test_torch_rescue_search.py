"""The rescue's radius search on the card (sigmap_tpu_torch/mapping/rescue.py),
run here through the plain version of its kernel, against the host k-d tree
(native.KdTree.radius_batch): the same windows and distances for every
query, bit for bit, on random queries and on queries at the radius'
boundary; the tree's own answer where a query passes per_cap; buffers
grown for a chunk that needs more; the oracle's streaming reads and the
turbo mapper's rescued records unchanged by it, and the latter held to the
JAX package's rescue.

The index is the port's own (100 kb, as tests/_torch_gpu_util.py's), the
tile store has tiles of 256 windows, and the rescue workload is
tests/test_torch_oracle.py's (S=16, K=1) at the default radius, built with
the port's synth, so that reads overflow and go to the rescue.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sigmap_tpu_torch import native
from sigmap_tpu_torch.config import SigmapConfig
from sigmap_tpu_torch.index.build import build_index
from sigmap_tpu_torch.index.sweep import SweepIndex
from sigmap_tpu_torch.io.fasta import ReferenceSequence
from sigmap_tpu_torch.io.pore_model import make_synthetic_pore_model
from sigmap_tpu_torch.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu_torch.mapping import rescue as R
from sigmap_tpu_torch.mapping import turbo as port
from sigmap_tpu_torch.mapping.spans import new_pass, span
from sigmap_tpu_torch.mapping.sweep_search import prepare_round
from sigmap_tpu_torch.oracle import Oracle
from sigmap_tpu_torch.synth import random_genome, simulate_reads
from _torch_util import (jax_native_from_source,  # noqa: F401 - fixtures
                         workload)
from test_torch_turbo import _without_mt

RADIUS = 0.08


def _loci(records):
    return {r.read_name: (r.ref_index, r.direction, r.fragment_start,
                          r.fragment_length, r.mapq)
            for r in records if r.is_mapped}


@pytest.fixture(scope="module")
def setup():
    """The 100 kb index, its tile store on the CPU, its oracle (whose k-d
    tree is the reference) and a CardSearch over the store."""
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(100_000, seed=7)
    idx = build_index([ReferenceSequence(n, c) for n, c in genome], pore,
                      cfg.index, RADIUS, verbose=False)
    oracle = Oracle(idx, cfg)
    sw = SweepIndex.build(idx, RADIUS, tile=256)
    store = port.tile_store_from_sweep(sw, "cpu")
    return cfg, idx, sw, oracle, R.CardSearch(store, idx, "cpu")


def _queries(idx, kind, n=64, seed=3):
    W = np.lib.stride_tricks.sliding_window_view(idx.values, idx.dim)
    rng = np.random.default_rng(seed)
    base = W[rng.integers(0, idx.n_windows, n)].astype(np.float32)
    if kind == "random":
        noisy = base + rng.normal(0, 0.1, base.shape)
        pure = rng.normal(0, 1, (8, idx.dim))
        return np.concatenate([noisy, pure]).astype(np.float32)
    # each query at d^2 = RADIUS * (1 + u), |u| <= 1e-4, from its window
    u = rng.normal(size=base.shape)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = np.sqrt(RADIUS * (1 + rng.uniform(-1e-4, 1e-4, (n, 1))))
    return (base + u * scale).astype(np.float32)


def _rotation_rounding(sw, q, fi, fd, fc):
    """The largest |d^2 in the store's rotated basis - d^2| over RADIUS
    among the matches (fi, fd, fc) of the queries q: the error that EPS
    has to cover 100 times."""
    slot = np.empty(sw.n_windows, np.int64)
    slot[sw.perm] = np.arange(sw.n_windows)
    s = slot[fi]
    w = sw.tiles[s // sw.tile, :sw.dim, s % sw.tile]
    qr = ((q - sw.mu) @ sw.rot).astype(np.float32)
    diff = w - qr[np.repeat(np.arange(len(fc)), fc)]
    d2 = (diff * diff).sum(axis=1, dtype=np.float32)
    return float(np.abs(d2 - fd).max()) / RADIUS


def _by_query_and_window(fi, fd, fc):
    """(fi, fd) of a radius_batch answer with each query's matches in
    window order."""
    q = np.repeat(np.arange(len(fc)), fc)
    order = np.lexsort((fi, q))
    return fi[order], fd[order]


@pytest.mark.parametrize("kind", ["random", "boundary"])
def test_card_search_equals_the_kd_tree(setup, kind):
    """Per query the same windows with the same f32 distances (bits), the
    same counts (the order within a query is free); queries by the radius'
    boundary find matches within 1e-4 of it, and the rotation's rounding
    stays 100 times below EPS."""
    _, idx, sw, oracle, card = setup
    q = _queries(idx, kind)
    want = oracle.tree.radius_batch(q, RADIUS, per_cap=5000)
    got = card(q, RADIUS, per_cap=5000)
    assert got is not None
    fi, fd, fc = got
    assert fi.dtype == np.int32 and fd.dtype == np.float32
    assert fc.dtype == np.int32
    np.testing.assert_array_equal(fc, want[2])
    wi, wd = _by_query_and_window(*want)
    gi, gd = _by_query_and_window(fi, fd, fc)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))
    assert len(fi) > 0
    if kind == "boundary":
        assert np.any(wd >= np.float32(RADIUS * (1 - 1e-4)))
    assert 0 < _rotation_rounding(sw, q, *want) * 100 <= R.EPS


def test_a_query_past_per_cap_takes_the_tree(setup):
    """With a per_cap some query passes, the card answers None and the
    mapper's chunk search returns the tree's arrays as they are, in a
    rescue.search span with device 0 and its queries past per_cap
    (``past_cap``, those whose answer holds per_cap matches), counted on
    the host."""
    cfg, idx, _, oracle, card = setup
    q = _queries(idx, "random")
    want = oracle.tree.radius_batch(q, RADIUS, per_cap=2)
    assert want[2].max() == 2
    assert card(q, RADIUS, per_cap=2) is None
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(S=256, K=16,
                                                         RING=64, TILE=256),
                              device="cpu")
    try:
        stamps = new_pass(0)
        with span(stamps, "rescue.read") as read:
            got = mapper._rescue_search(card, oracle.tree, stamps, read, q,
                                        RADIUS, 2)
            again = mapper._rescue_search(card, oracle.tree, stamps, read,
                                          q, RADIUS, 5000)
    finally:
        mapper.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    searches = [s for s in stamps["spans"] if s.name == "rescue.search"]
    assert [s.numbers for s in searches] == [
        dict(device=0, seeds=len(q), matches=len(want[0]),
             past_cap=int((want[2] == 2).sum())),
        dict(device=1, seeds=len(q), matches=len(again[0]), past_cap=0)]
    assert searches[0].numbers["past_cap"] > 0
    assert all(s.parent == read.index for s in searches)
    assert (mapper.n_rescue_search_host,
            mapper.n_rescue_search_device) == (1, 1)


def test_a_chunk_past_the_buffers_grows_them(setup, monkeypatch):
    """Buffers that hold neither the chunk's table nor its candidates are
    grown to hold both, and the answer is still the tree's; the next chunk
    reuses them."""
    _, idx, sw, oracle, card = setup
    monkeypatch.setattr(R, "IN_WORDS", 64)
    monkeypatch.setattr(R, "OUT_WORDS", 64)
    small = R.CardSearch(card.store, idx, "cpu")
    q = _queries(idx, "random")
    want = oracle.tree.radius_batch(q, RADIUS, per_cap=5000)
    got = small(q, RADIUS, per_cap=5000)
    assert got is not None
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(_by_query_and_window(*got), _by_query_and_window(*want)):
        np.testing.assert_array_equal(a, b)
    d_in, d_out, _, _ = small._bufs
    span = R.probe_span(RADIUS * (1 + R.EPS), sw.cell_width)
    NO = span ** (len(sw.radixes) - 1)
    assert d_in.numel() == len(q) * (8 + 2 * NO + 1) > 64
    # the plain kernel's candidates: the matches and those just past RADIUS
    assert d_out.numel() >= 1 + len(q) + 3 * len(want[0]) > 64
    small(q[:8], RADIUS, per_cap=5000)
    assert small._bufs[0] is d_in and small._bufs[1] is d_out


@pytest.mark.parametrize("n", [70, 200])
@pytest.mark.parametrize("span_", [3, 4])
def test_block_table_equals_prepare_round(setup, span_, n):
    """The host block table (csrc/rescue_host.cc) is prepare_round's at
    one seed a block: the rotated seeds sorted by cell key, the block table
    and the order, exactly, and not a word past them."""
    cfg, idx, sw, _, card = setup
    queries = _queries(idx, "random", n=n)[:n]
    radius = RADIUS * (1 + R.EPS)
    NO = span_ ** (len(sw.radixes) - 1)
    out = np.full(n * (8 + 2 * NO + 1) + 16, -7, np.int32)
    words, rows = R.block_table(queries, card.store, card.host, radius,
                                span_, NO, out)
    assert words == n * 8 + (2 * NO + 1) * n
    assert (out[words:] == -7).all()
    seeds = np.zeros((n, 8), np.float32)
    seeds[:, :idx.dim] = queries
    t = [torch.from_numpy(a) for a in (seeds, sw.cum, sw.rot, sw.mu,
                                       sw.origin)]
    want = prepare_round(t[0], t[1], sw.n_tiles, t[2], t[3], t[4], radius,
                         sw.tile, idx.dim, 1, sw.radixes, span_,
                         sw.cell_width)
    np.testing.assert_array_equal(out[:n * 8].view(np.float32).reshape(n, 8),
                                  want[0].numpy())
    np.testing.assert_array_equal(out[n * 8:words].reshape(2 * NO + 1, n),
                                  want[1].numpy())
    np.testing.assert_array_equal(rows, want[2].numpy())
    assert R.probe_span(radius, sw.cell_width) == 4


def _chain_key(c):
    a = c.anchors
    return (c.ref_index, c.direction, c.start_position, c.end_position,
            c.num_anchors, float(c.score), c.mapq,
            a["target"].tobytes(), a["query"].tobytes(), a["dist"].tobytes())


def test_streaming_read_with_the_card_search(setup):
    """Oracle.streaming_read gives the same (chunk_idx, num_events, chains,
    stopped) with the card search as with the tree, on on-target reads and
    on reads of a genome that is not indexed (which run every chunk); the
    card answers every chunk."""
    cfg, idx, _, oracle, card = setup
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(100_000, seed=7)
    reads = (simulate_reads(pore, genome, 3, seed=21, read_bases=2000)
             + simulate_reads(pore, random_genome(20_000, seed=9), 2,
                              seed=22, read_bases=2000))
    answered = []

    def search(q, radius_sq, per_cap):
        got = card(q, radius_sq, per_cap)
        answered.append(got is not None)
        return got

    chunks = []
    for r in reads:
        pa = dac_to_pa(r.raw, r.digitisation, r.range, r.offset)
        ci, ne, chains, stopped = oracle.streaming_read(pa)
        ci2, ne2, chains2, stopped2 = oracle.streaming_read(pa, search)
        assert (ci, ne, stopped) == (ci2, ne2, stopped2)
        assert [_chain_key(c) for c in chains] == \
            [_chain_key(c) for c in chains2]
        chunks.append(ci)
    assert max(chunks) >= 2 and all(answered)


@pytest.fixture(scope="module")
def rescue_workload():
    """tests/test_torch_oracle.py:test_port_rescue_matches_jax's setup at
    the default radius: 32 reads of 2000 bases on a 200 kb index, read
    batch 32, two rescue threads."""
    cfg = SigmapConfig()
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=32,
                                         num_threads=2))
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(200_000, seed=11)
    idx = build_index([ReferenceSequence(n, c) for n, c in genome], pore,
                      cfg.index, cfg.mapping.search_radius, verbose=False)
    reads = simulate_reads(pore, genome, 32, seed=5, read_bases=2000)
    signals = [ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                          dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
               for r in reads]
    return cfg, idx, signals


def test_turbo_card_rescue_equals_the_kd_rescue(rescue_workload):
    """A turbo mapper whose rescue searches through the card search (set
    on the CPU by the class attribute, running the kernel's plain version)
    gives the records of one whose rescue searches the tree, apart from
    mt:; its rescue.search spans are children of rescue.read spans and say
    where each chunk was searched, as its counters do."""
    cfg, idx, signals = rescue_workload
    params = port.TurboParams(S=16, K=1, RING=64, TILE=256)
    out = {}
    for card in (False, True):
        mapper = port.TurboMapper(idx, cfg, params, device="cpu")
        assert mapper._card_rescue is False
        mapper._card_rescue = card
        try:
            out[card] = (_without_mt(mapper.streaming_map(signals)),
                         mapper.last_pass, mapper.n_rescued,
                         mapper.n_rescue_search_device,
                         mapper.n_rescue_search_host)
        finally:
            mapper.close()
    assert out[True][0] == out[False][0]
    assert out[True][2] == out[False][2] > 0
    for card, (_, stamps, _, n_dev, n_host) in out.items():
        spans = stamps["spans"]
        searches = [s for s in spans if s.name == "rescue.search"]
        assert len(searches) == n_dev + n_host > 0
        assert all(spans[s.parent].name == "rescue.read" for s in searches)
        on = sum(s.numbers["device"] for s in searches)
        assert on == n_dev
        assert (n_dev > 0) is card and (n_host > 0 or card)
    assert out[False][3] == 0


def test_port_card_rescue_matches_jax(workload, jax_native_from_source):
    """tests/test_torch_oracle.py:test_port_rescue_matches_jax with the card
    search in the port's rescue (its plain version here): the port maps the
    same reads at the same loci as the JAX mapper, more reads than without
    the rescue, and the card answers chunks."""
    from sigmap_tpu.index.build import build_index as jax_build_index
    from sigmap_tpu.io.fasta import ReferenceSequence as JaxSeq
    from sigmap_tpu.io.pore_model import \
        make_synthetic_pore_model as jax_pore
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu.synth import random_genome as jax_genome

    cfg, _, _, signals = workload
    cfg = dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, search_radius=0.5),
        runtime=dataclasses.replace(cfg.runtime, read_batch=32,
                                    num_threads=2),
    )
    idx = jax_build_index(
        [JaxSeq(n, c) for n, c in jax_genome(200_000, seed=11)],
        jax_pore(k=6, seed=0), cfg.index, cfg.mapping.search_radius,
        verbose=False,
    )
    signals = signals[:32]
    base = dict(S=16, K=1, RING=64, TILE=256)
    no_rescue = port.TurboMapper(
        idx, cfg, port.TurboParams(rescue=False, **base), device="cpu"
    ).streaming_map(signals)
    tm = port.TurboMapper(idx, cfg, port.TurboParams(**base), device="cpu")
    tm._card_rescue = True
    try:
        rescued = tm.streaming_map(signals)
    finally:
        tm.close()
    want = TurboMapper(
        idx, cfg, TurboParams(rescue=True, peaks_impl="scan", **base)
    ).streaming_map(signals)
    assert tm.n_rescued > 0 and tm.n_rescue_search_device > 0
    assert sum(r.is_mapped for r in no_rescue) < \
        sum(r.is_mapped for r in rescued)
    assert _loci(rescued) == _loci(want)
