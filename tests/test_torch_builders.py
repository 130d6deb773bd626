"""The set-up builders of sigmap_tpu_torch: the index and the tile store
built in plain torch (``sigmap_tpu_torch/builders.py``) against the host
builders, bit for bit, on the CPU; the packed meta's split sized from the
index (``index/sweep.py:meta_pos_bits``); the k-d tree built on several
threads against one; and the mapper on the torch builders against the
benchmark's plain reference."""

import contextlib
import dataclasses
import os

import numpy as np
import pytest

from sigmap_tpu_torch import builders, native
from sigmap_tpu_torch.config import SigmapConfig
from sigmap_tpu_torch.index.build import SignalIndex, build_index, \
    pack_position
from sigmap_tpu_torch.index.sweep import META_POS_BITS, SweepIndex, \
    meta_pos_bits
from sigmap_tpu_torch.io.fasta import ReferenceSequence
from sigmap_tpu_torch.io.pore_model import make_synthetic_pore_model

CFG = SigmapConfig()
PORE = make_synthetic_pore_model(k=6, seed=0)
K_MASK = CFG.index.dimension + PORE.k - 1
INDEX_FIELDS = ("values", "positions", "perm", "cell_keys", "cell_starts",
                "win_group", "win_pos")
STORE_ARRAYS = ("tiles", "meta", "cum", "rot", "mu", "origin", "perm",
                "meta_flat")
STORE_SCALARS = ("radixes", "span", "n_windows", "tile", "dim",
                 "cell_width", "radius", "pos_bits")


def genome(seed: int) -> list:
    """Five sequences: a 300-base motif repeated 31 times in four of them
    (its k-mers are frequent, so masked), a run of 40 A (a constant
    signal: dedup drops a run of it), an N run, random bases, and a
    sequence too short for a window.  The four start with 10 A and an N,
    so their first window ends on the N (masked) and their next points
    are the A level, and end on 30 A, the level their stream's dedup last
    kept: at a wide delta a stream's first unmasked point is dropped."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, 4, 300).astype(np.uint8)
    out = []
    for i in range(4):
        parts = [np.zeros(10, np.uint8), np.full(1, 4, np.uint8),
                 np.zeros(30, np.uint8)]
        if i % 2 == 0:
            parts.append(motif)
        parts.append(rng.integers(0, 4, rng.integers(5_000, 30_000))
                     .astype(np.uint8))
        parts += [np.zeros(40, np.uint8), np.full(7, 4, np.uint8)]
        for _ in range(30):
            parts += [motif, rng.integers(0, 4, 50).astype(np.uint8)]
        parts += [rng.integers(0, 4, 3_000).astype(np.uint8),
                  np.zeros(30, np.uint8)]
        out.append((f"s{i}", np.concatenate(parts)))
    out.append(("tiny", rng.integers(0, 4, 9).astype(np.uint8)))
    return out


def seqs_of(g):
    return [ReferenceSequence(n, c.copy()) for n, c in g]


def host_streams(g, icfg):
    """Each stream's (sequence, strand, mask, kept positions) as the host
    builder makes them, in its order."""
    seqs = seqs_of(g)
    for s in seqs:
        s.prepare_negative()
    pos_m, neg_m = native.kmer_masks([s.codes for s in seqs],
                                     [s.neg_codes for s in seqs], K_MASK,
                                     icfg.mask_frequency)
    idx = build_index(seqs_of(g), PORE, icfg, verbose=False)
    p = idx.positions
    out = []
    for strand, masks in ((0, pos_m), (1, neg_m)):
        for si, m in enumerate(masks):
            if not len(m):
                continue
            sel = ((p >> np.uint64(33)) == si) & ((p & np.uint64(1))
                                                  == strand)
            out.append((si, strand, m, ((p[sel] >> np.uint64(1))
                                        & np.uint64(0xFFFFFFFF))
                        .astype(np.int64)))
    return out


CASES = [(1, 0.01), (2, 0.01), (3, 0.5), (4, 0.5)]


@pytest.mark.parametrize("seed,delta", CASES)
def test_torch_index_equals_the_host_index(seed, delta):
    """build_index on a torch device (here the CPU) gives the host build's
    index bit for bit, on a genome whose masks mask windows, whose dedup
    drops runs of two and more points and, at the wider delta, drops the
    first unmasked point of a stream whose position 0 is masked."""
    g = genome(seed)
    icfg = dataclasses.replace(CFG.index, dedup_delta=delta)
    want = build_index(seqs_of(g), PORE, icfg, verbose=False)
    got = builders.build_index(seqs_of(g), PORE, icfg, 0.08, "cpu")
    for f in INDEX_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("dim", "max_leaf", "bucket_dims", "cell_width", "ref_names",
              "ref_lengths"):
        assert getattr(want, f) == getattr(got, f), f
    assert want.build_span.name == "setup.index"
    # what the genome exercises, as the host builder saw it
    streams = host_streams(g, icfg)
    assert sum(int(m.sum()) for _, _, m, _ in streams) > 0
    runs = 0
    for _, _, m, kept in streams:
        dropped = ~m.copy()
        dropped[kept] = False            # unmasked and not kept
        runs += int((dropped[1:] & dropped[:-1]).sum())
    assert runs > 0
    if delta > 0.1:
        assert any(m[0] and int(np.flatnonzero(~m)[0]) not in set(
            kept.tolist()) for _, _, m, kept in streams[1:])


def test_build_cached_writes_then_reads_the_host_store(tmp_path):
    """SweepIndex.build_cached with a cache directory: the first call
    builds in torch and writes the store, the second reads it back; both
    give SweepIndex.build's tiles and meta and its split."""
    idx = build_index(seqs_of(genome(5)), PORE, CFG.index, verbose=False)
    want = SweepIndex.build(idx, 0.08, tile=256)
    for read in (False, True):
        sw, tiles, meta = SweepIndex.build_cached(
            idx, 0.08, tile=256, cache_dir=str(tmp_path), device="cpu")
        assert len(list(tmp_path.glob("sweep_*.npz"))) == 1
        assert (sw.tiles is not None) == read   # a build keeps no host copy
        assert np.array_equal(tiles.numpy(), want.tiles)
        assert np.array_equal(meta.numpy(), want.meta)
        assert np.array_equal(sw.cum, want.cum)
        assert np.array_equal(sw.perm, want.perm)
        assert sw.pos_bits == want.pos_bits


@pytest.mark.parametrize("seed,delta", CASES)
def test_torch_tile_store_equals_the_host_store(seed, delta):
    """builders.sweep_store on the CPU gives SweepIndex.build's store bit
    for bit: tiles, meta, cell table, basis, permutation."""
    icfg = dataclasses.replace(CFG.index, dedup_delta=delta)
    idx = build_index(seqs_of(genome(seed)), PORE, icfg, verbose=False)
    want = SweepIndex.build(idx, 0.08, tile=256)
    got = builders.materialize(*builders.sweep_store(idx, 0.08, tile=256,
                                                     device="cpu"))
    for f in STORE_ARRAYS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in STORE_SCALARS:
        assert getattr(want, f) == getattr(got, f), f


def fake_index(groups_pos, seed=0):
    """A SignalIndex whose windows have the given (sequence, strand,
    position) triples (values random), for the packed meta."""
    rng = np.random.default_rng(seed)
    dim = CFG.index.dimension
    n = len(groups_pos)
    values = rng.normal(0, 1, n + dim - 1).astype(np.float32)
    pos = np.concatenate([
        pack_position(si, np.asarray([p], np.uint64), strand)
        for si, strand, p in groups_pos] + [np.zeros(dim - 1, np.uint64)])
    n_seqs = max(si for si, _, _ in groups_pos) + 1
    idx = SignalIndex(
        dim=dim, max_leaf=20, bucket_dims=4, cell_width=0.28,
        values=values, positions=pos, perm=np.arange(n, dtype=np.int32),
        cell_keys=np.zeros(1, np.int32),
        cell_starts=np.asarray([0, n], np.int32),
        ref_names=[f"r{i}" for i in range(n_seqs)],
        ref_lengths=[1 << 30] * n_seqs)
    idx.derive_window_metadata()
    return idx


@pytest.mark.parametrize("n_groups,max_pos,bits", [
    (2, 1000, 25), (64, (1 << 25) - 1, 25), (2, 1 << 25, 26),
    (4, 64_444_167, 26), (66, 5_000_000, 24), (80, 1000, 24),
    (1 << 10, 1000, 21), (2, (1 << 30) - 1, 30)])
def test_meta_pos_bits_keeps_25_where_the_index_fits(n_groups, max_pos,
                                                     bits):
    """25 position bits wherever the groups leave them (every index the
    JAX package takes), else what the largest position needs."""
    assert meta_pos_bits(n_groups, max_pos) == bits


@pytest.mark.parametrize("n_groups,max_pos", [(66, 1 << 25), (2, 1 << 31),
                                              (1 << 8, 1 << 24)])
def test_meta_pos_bits_raises_past_31_bits(n_groups, max_pos):
    with pytest.raises(ValueError) as e:
        meta_pos_bits(n_groups, max_pos)
    g = (n_groups - 1).bit_length()
    assert f"{g} group bits" in str(e.value)
    assert f"{max_pos.bit_length()} position bits" in str(e.value)


def test_stores_raise_past_31_bits():
    """33 sequences (66 groups, 7 bits) with a position past 2^25 (26
    bits): both store builders refuse the index."""
    idx = fake_index([(i, 0, 100 * i) for i in range(33)]
                     + [(0, 0, 1 << 25)])
    for build in (lambda: SweepIndex.build(idx, 0.08, tile=256),
                  lambda: builders.sweep_store(idx, 0.08, tile=256,
                                               device="cpu")):
        with pytest.raises(ValueError, match="7 group bits"):
            build()


@pytest.mark.parametrize("layout", ["past-2^25", "40-sequences"])
def test_meta_round_trips_group_and_position(layout):
    """Each window's packed meta decodes, with the store's split, to its
    group and position, in both store builders and in the mapper's
    decode (anchors_qpos_major), for positions at and past 2^25 and for
    more than 32 sequences."""
    import torch

    from sigmap_tpu_torch.mapping.turbo import anchors_qpos_major

    rng = np.random.default_rng(3)
    if layout == "past-2^25":
        triples = [(int(rng.integers(2)), int(rng.integers(2)),
                    int(p)) for p in rng.integers((1 << 25) - 50,
                                                  64_444_167, 3000)]
        triples[0] = (1, 1, 1 << 25)
        bits = 26
    else:
        triples = [(int(rng.integers(40)), int(rng.integers(2)),
                    int(p)) for p in rng.integers(0, 5_000_000, 3000)]
        bits = 24
    idx = fake_index(triples)
    host = SweepIndex.build(idx, 0.08, tile=256)
    card = builders.materialize(*builders.sweep_store(idx, 0.08, tile=256,
                                                      device="cpu"))
    assert host.pos_bits == card.pos_bits == bits
    assert np.array_equal(host.meta, card.meta)
    g = idx.win_group[host.perm]
    p = idx.win_pos[host.perm]
    assert np.array_equal(host.meta_flat >> bits, g)
    assert np.array_equal(host.meta_flat & ((1 << bits) - 1), p)
    # the mapper's decode: all of one read's slots filled
    n = len(triples) // 8 * 8
    m = torch.from_numpy(host.meta_flat[:n]).view(n // 8, 8)
    n_t, _, _, n_g = anchors_qpos_major(
        m, torch.zeros(n // 8, 8), torch.full((n // 8,), 8),
        torch.zeros(1, n // 8, dtype=torch.int32), 1, n // 8, 8, bits)
    assert np.array_equal(n_t.t().reshape(-1).numpy(), p[:n])
    assert np.array_equal(n_g.t().reshape(-1).numpy(), g[:n])


@pytest.mark.parametrize("bits", [21, 24, 25, 26, 30])
def test_meta_sorts_as_group_then_position(bits):
    """Under every split the packed meta orders windows by group, then
    position: where the old split (25) fits, as it did."""
    rng = np.random.default_rng(bits)
    g = rng.integers(0, 1 << (31 - bits), 5000)
    p = rng.integers(0, 1 << min(bits, 25), 5000)
    new = (g << bits) | p
    old = (g << 25) | p
    want = np.lexsort((p, g))
    assert np.array_equal(np.argsort(new, kind="stable"), want)
    if (g < 64).all():
        assert np.array_equal(np.argsort(old, kind="stable"), want)
    assert META_POS_BITS == 25


def tree_values(n: int = 60_000) -> np.ndarray:
    """A z-scored random walk rounded to 1/40: many equal coordinates, so
    some splits fall back to the median."""
    rng = np.random.default_rng(7)
    v = np.cumsum(rng.normal(0, 1, n))
    v = (v - v.mean()) / v.std()
    return (np.round(v * 40) / 40).astype(np.float32)


@contextlib.contextmanager
def on_cores(n: int):
    """The calling thread may run on ``n`` of its cores, which is as many
    threads as native.KdTree builds on."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < n:
        pytest.skip(f"{n} cores asked for, {len(cores)} available")
    os.sched_setaffinity(0, cores[:n])
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)


def kd_tree_on(n: int, vals: np.ndarray):
    with on_cores(n):
        return native.KdTree(vals, 6, 20)


@pytest.fixture(scope="module")
def one_thread_tree():
    vals = tree_values()
    t = kd_tree_on(1, vals)
    return vals, t, t.layout()


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_tree_on_threads_is_the_one_thread_tree(one_thread_tree, threads):
    """The k-d tree built on 1, 2 and 8 threads: the same window order and
    the same nodes as on one, and so the same radius_batch answers, also
    where per_cap cuts a query's matches (the tree keeps the first in its
    leaf order)."""
    vals, ref, (order, links, splits) = one_thread_tree
    t = kd_tree_on(threads, vals)
    o, l, s = t.layout()
    assert np.array_equal(o, order)
    assert np.array_equal(l, links)
    assert np.array_equal(s, splits)
    rng = np.random.default_rng(threads)
    qs = np.lib.stride_tricks.sliding_window_view(vals, 6)[
        rng.integers(0, len(vals) - 6, 300)] + rng.normal(0, 0.05, (300, 6))
    for cap in (4, 5000):
        got = t.radius_batch(qs.astype(np.float32), 0.3, per_cap=cap)
        want = ref.radius_batch(qs.astype(np.float32), 0.3, per_cap=cap)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        if cap == 4:
            assert (got[2] == cap).sum() > 10


@pytest.fixture(scope="module")
def tiny_cell_inputs():
    """A benchmark cell cut to 40 sequences of 4 kb (more than 32, so the
    packed meta has 24 position bits) and calls of 12 reads."""
    from benchmark import workload
    from benchmark.reference import Reference

    bench = workload.load_benchmark()
    cell = workload.load_cell(bench, "ecoli.short")
    cell.config = dict(cell.config, contigs=[[f"c{i}", 4_000]
                                             for i in range(40)])
    cell.traffic = dict(cell.traffic, reads_per_call=12, read_batch=12,
                        pool_calls=2)
    inputs = workload.make_inputs(cell, SEED)
    ref = Reference(inputs.genome, inputs.pore, cell.config["turbo_params"],
                    "cpu")
    return cell, inputs, ref


SEED = 2**31 + 1818


def test_mapper_on_the_torch_builders_agrees_with_the_reference(
        tiny_cell_inputs):
    """The port's index and tile store built in torch on the CPU, mapped
    through TurboMapper: every record the benchmark's check compares
    equals the plain reference's."""
    from benchmark import compare, synthgen, window, workload
    from sigmap_tpu_torch.io.pore_model import PoreModel
    from sigmap_tpu_torch.io.signals import ReadSignal
    from sigmap_tpu_torch.mapping.spans import setup_span
    from sigmap_tpu_torch.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu_torch.oracle import Oracle

    cell, inputs, ref = tiny_cell_inputs
    cfg = workload.sigmap_config(cell)
    lm = inputs.pore.level_mean
    z = np.zeros_like(lm)
    with setup_span("setup.index") as sp:
        idx = builders.build_index(seqs_of(inputs.genome),
                                   PoreModel(inputs.pore.k, lm, z, z, z),
                                   cfg.index, cfg.mapping.search_radius,
                                   "cpu")
    idx.build_span = sp
    mapper = TurboMapper(idx, cfg, TurboParams(**cell.config["turbo_params"]),
                         device="cpu", oracle=Oracle(idx, cfg))
    assert mapper.store.pos_bits == 24
    parts = [[ReadSignal(r, synthgen.DIGITISATION, synthgen.DAC_RANGE,
                         synthgen.DAC_OFFSET, pa) for r, pa in h]
             for h in inputs.pools]
    try:
        run = window.drive(mapper, parts, 0.0, SEED, lambda: None)
    finally:
        mapper.close()
    build = run.calls[0].stamps["build"]
    assert [s.name for s in build] == ["setup.index", "setup.tree",
                                       "setup.tile_store"]
    assert run.calls[0].stamps["store_bytes"] == mapper.store.device_bytes()
    sample = compare.sampled_reads(
        run, inputs, compare.draw_sample(run, SEED),
        cell.traffic["read_batch"], ref.cfg)
    v = compare.judge(ref, sample, sum(c.n - len(c.records)
                                       for c in run.calls), SEED)
    assert v.correct, v.lines()
    assert sum(len(c.records) for c in run.calls) > 0
