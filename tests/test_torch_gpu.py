"""The port on the GPU: every CUDA kernel against its plain version, and the
device paths of the exact engine, its radius search and the align modes
against their CPU runs, exactly.

Every case needs a CUDA device (``gpu`` mark, ``cuda_device`` fixture) and
skips without one.  The file imports nothing of the JAX package, jax or
h5py (its inputs come from tests/_torch_gpu_util.py and chip_smoke.py), so
it runs where the card is:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``chip_smoke.py`` runs it so, and fails unless every case passes).
"""

import dataclasses
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from _torch_gpu_util import (  # noqa: F401 - fixtures
    DIM, DRIVER_CFG, RADIUS, SEARCH_KW, SEARCH_RADIUS, SEARCH_TIGHT,
    closest_k_queries, cuda_device, debug_work, driver_setup, gpu_genome,
    gpu_pore, kernels_case, quantize_reads, ragged_pairs, random_chain_case,
    search_setup,
    sweep_index, uniform_pairs,
)
from sigmap_tpu_torch import LAUNCHES
from sigmap_tpu_torch.config import ChainingConfig, EventDetectorConfig

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    ADV_WINDOW_ROWS, chain_adversarial, compress_adversarial,
    peaks_adversarial, run_shard_ranks, sdtw_adversarial, shard_differences,
    shard_equal, threaded_shard_map,
)

pytestmark = pytest.mark.gpu

# --- B4 (chain_fused) -------------------------------------------------------

def _chain_equals_plain(args, dev, **kw):
    from sigmap_tpu_torch.ops.chain_fused import chain_fused, chain_fused_plain

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    plain_kw = {k: v for k, v in kw.items() if k != "window_rows"}
    before = LAUNCHES["chain_fused"]
    k = chain_fused(*args, **kw)
    assert LAUNCHES["chain_fused"] == before + 1
    p = chain_fused_plain(*args, **plain_kw)
    for a, b in zip([k[0], k[1], *k[2]], [p[0], p[1], *p[2]]):
        assert torch.equal(a, b)


def test_chain_fused_kernel_matches_plain_on_gpu(cuda_device):
    rng = np.random.default_rng(3)
    _chain_equals_plain(random_chain_case(rng, 64 + 8 * 16, 70, 64),
                        cuda_device, radius=RADIUS, dim=DIM, ring=64,
                        cfg=ChainingConfig(), kb=8)


@pytest.mark.parametrize("kb", [1, 4, 8])
def test_chain_fused_kernel_matches_plain_on_adversarial_reads(cuda_device,
                                                               kb):
    args, kw = chain_adversarial(0)
    _chain_equals_plain(args, cuda_device, cfg=ChainingConfig(), kb=kb, **kw)


@pytest.mark.parametrize("kb", [1, 4, 8, 16])
def test_chain_fused_kernel_matches_plain_in_windows(cuda_device, kb):
    """chain_adversarial's reads in windows of ADV_WINDOW_ROWS new rows (4 a
    read: the rules of reads 8-12 cross them) and of kb rows, the smallest
    window."""
    args, kw = chain_adversarial(0)
    for w in (ADV_WINDOW_ROWS, kb):
        _chain_equals_plain(args, cuda_device, cfg=ChainingConfig(), kb=kb,
                            window_rows=w, **kw)


def test_chain_fused_kernel_matches_plain_on_long_reads(cuda_device):
    """Random reads of 640 new rows: whole, in windows of 64 rows (10 a
    read) and of 200 (a short last window)."""
    from sigmap_tpu_torch.ops.chain_fused import check_fits

    rng = np.random.default_rng(11)
    args = random_chain_case(rng, 64 + 8 * 80, 40, 64)
    assert check_fits(64 + 8 * 80, 64, 64, 8) == 0
    for w in (None, 64, 200):
        _chain_equals_plain(args, cuda_device, radius=RADIUS, dim=DIM,
                            ring=64, cfg=ChainingConfig(), kb=8,
                            window_rows=w)


# --- B1 / B2 (events) -------------------------------------------------------

def test_event_kernels_match_plain_on_gpu(cuda_device):
    from sigmap_tpu_torch.signal import events as tev
    from sigmap_tpu_torch.signal import events_kernels as tk

    sigs, lengths = kernels_case()
    cfg = EventDetectorConfig()
    x = torch.from_numpy(sigs).to(cuda_device)
    n = torch.from_numpy(lengths).to(cuda_device)
    t1 = tev.batch_tstat(x, n, cfg.window_length1)
    t2 = tev.batch_tstat(x, n, cfg.window_length2)
    assert torch.equal(tk.detect_peaks(t1, t2, n, cfg),
                       tk.detect_peaks_plain(t1, t2, n, cfg))
    a1, a2, a_len = (torch.from_numpy(a).to(cuda_device)
                     for a in peaks_adversarial(0))
    for C in (a1.shape[1], a1.shape[1] // 4 * 4):   # padded rows, and as is
        b1, b2 = a1[:, :C].contiguous(), a2[:, :C].contiguous()
        b_len = a_len.clamp(max=C)
        want = tk.detect_peaks_plain(b1, b2, b_len, cfg)
        assert torch.equal(tk.detect_peaks(b1, b2, b_len, cfg), want)
    # a contiguous view that starts 4 bytes off a 16-byte boundary
    off = torch.cat([b1.new_zeros(1), b1.reshape(-1)])[1:].view(b1.shape)
    assert off.data_ptr() % 16 and off.is_contiguous()
    assert torch.equal(tk.detect_peaks(off, b2, b_len, cfg), want)
    norm = torch.randn(64, 1024, device=cuda_device)
    cnt = torch.randint(0, 1024, (64,), device=cuda_device, dtype=torch.int32)
    assert torch.equal(tk.compress_keep(norm, cnt, 0.1).contiguous(),
                       tk.compress_keep_plain(norm, cnt, 0.1))


def test_compress_keep_kernel_matches_plain_on_adversarial_rows(cuda_device):
    """B2 on compress_adversarial's rows: E = 203 (padded rows), its first
    200 events (as they are), and a view 4 bytes off a 16-byte boundary;
    the mask comes back as a contiguous [R, E] i32 tensor."""
    from sigmap_tpu_torch.signal import events_kernels as tk

    norm, n, delta = compress_adversarial(0)
    x = torch.from_numpy(norm).to(cuda_device)
    c = torch.from_numpy(n).to(cuda_device)
    for E in (x.shape[1], x.shape[1] // 4 * 4):
        y = x[:, :E].contiguous()
        before = LAUNCHES["compress_keep"]
        got = tk.compress_keep(y, c, delta)
        assert LAUNCHES["compress_keep"] == before + 1
        assert got.shape == y.shape and got.dtype == torch.int32
        assert got.is_contiguous()
        want = tk.compress_keep_plain(y, c, delta)
        assert torch.equal(got, want)
    off = torch.cat([y.new_zeros(1), y.reshape(-1)])[1:].view(y.shape)
    assert off.data_ptr() % 16 and off.is_contiguous()
    assert torch.equal(tk.compress_keep(off, c, delta), want)


# --- B3 (sweep) -------------------------------------------------------------

def test_sweep_kernel_matches_plain_on_gpu(sweep_index, cuda_device):
    from sigmap_tpu_torch.index.sweep import SweepIndex
    from sigmap_tpu_torch.mapping.sweep_search import prepare_round
    from sigmap_tpu_torch.ops.sweep_kernel import (
        sweep_search, sweep_search_plain,
    )

    cfg, idx = sweep_index
    sw = SweepIndex.build(idx, 0.8, tile=256)
    qs, K = closest_k_queries(idx, sw.n_windows)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in
         (qs, sw.cum, sw.tiles, sw.meta, sw.rot, sw.mu, sw.origin)]
    qr_s, bm, _ = prepare_round(t[0], t[1], sw.n_tiles, t[4], t[5], t[6],
                                0.8, sw.tile, idx.dim, 8, sw.radixes,
                                sw.span, sw.cell_width)
    kw = dict(radius=0.8, K=K, TILE=sw.tile, dim=idx.dim, block=8)
    for a, b in zip(sweep_search(qr_s, bm, t[2], t[3], **kw),
                    sweep_search_plain(qr_s, bm, t[2], t[3], **kw)):
        assert torch.equal(a, b)


# --- the rescue's card search (rescue_search) -------------------------------

def test_card_builders_equal_the_host_builders(gpu_pore, cuda_device):
    """At E. coli K-12's size (4,641,652 random bases, some 9.2 M windows)
    the index and the tile store built on the card equal the host
    builders' bit for bit."""
    from sigmap_tpu_torch import builders
    from sigmap_tpu_torch.config import IndexConfig
    from sigmap_tpu_torch.index.build import build_index_host
    from sigmap_tpu_torch.index.sweep import SweepIndex
    from sigmap_tpu_torch.io.fasta import ReferenceSequence
    from sigmap_tpu_torch.synth import random_genome

    g = random_genome(4_641_652, seed=12)
    host = build_index_host([ReferenceSequence(n, c.copy()) for n, c in g],
                            gpu_pore, IndexConfig(), SEARCH_RADIUS)
    card = builders.build_index(
        [ReferenceSequence(n, c.copy()) for n, c in g], gpu_pore,
        IndexConfig(), SEARCH_RADIUS, cuda_device)
    for f in ("values", "positions", "perm", "cell_keys", "cell_starts",
              "win_group", "win_pos"):
        a, b = getattr(host, f), getattr(card, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    want = SweepIndex.build(host, SEARCH_RADIUS, tile=1024)
    got = builders.materialize(*builders.sweep_store(
        card, SEARCH_RADIUS, tile=1024, device=cuda_device))
    for f in ("tiles", "meta", "cum", "rot", "mu", "origin", "perm",
              "meta_flat"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("radixes", "n_windows", "cell_width", "pos_bits"):
        assert getattr(want, f) == getattr(got, f), f


def test_rescue_search_kernel_matches_plain_on_gpu(sweep_index, cuda_device):
    """The kernel's candidates equal its plain version's on the same seeds
    and tile store: each seed's count and the total exactly, and the set of
    (seed, slot, d^2) exactly (the kernel appends in no fixed order)."""
    from sigmap_tpu_torch.index.sweep import SweepIndex
    from sigmap_tpu_torch.mapping.rescue import (
        EPS, block_table, host_arrays, probe_span,
    )
    from sigmap_tpu_torch.mapping.turbo import tile_store_from_sweep
    from sigmap_tpu_torch.ops.rescue_search import (
        rescue_search, rescue_search_plain,
    )

    cfg, idx = sweep_index
    sw = SweepIndex.build(idx, RADIUS, tile=256)
    store = tile_store_from_sweep(sw, cuda_device)
    qs, _ = closest_k_queries(idx, sw.n_windows)
    qs = np.ascontiguousarray(qs[:, :idx.dim])
    radius = RADIUS * (1 + EPS)
    span = probe_span(radius, sw.cell_width)
    NO = span ** (len(sw.radixes) - 1)
    table = np.zeros(qs.shape[0] * (8 + 2 * NO + 1), np.int32)
    words, _ = block_table(qs, store, host_arrays(store), radius, span, NO,
                           table)
    Q, cap = qs.shape[0], 1 << 14
    seeds = torch.from_numpy(table[:Q * 8].view(np.float32).reshape(Q, 8))
    bm = torch.from_numpy(table[Q * 8:words].reshape(-1, Q))
    seeds, bm = seeds.to(cuda_device), bm.to(cuda_device)
    tiles = store.tiles
    got = {}
    for name, fn in (("kernel", rescue_search), ("plain",
                                                   rescue_search_plain)):
        out = torch.zeros(1 + Q + 3 * cap, dtype=torch.int32,
                          device=cuda_device)
        before = LAUNCHES["rescue_search"]
        fn(seeds, bm, tiles, radius, idx.dim, out)
        torch.cuda.synchronize()
        assert LAUNCHES["rescue_search"] == before + (name == "kernel")
        out = out.cpu().numpy()
        n = int(out[0])
        got[name] = (out[:1 + Q], sorted(map(tuple, out[1 + Q:].reshape(
            cap, 3)[:n].tolist())))
    assert 0 < int(got["plain"][0][0]) <= cap
    np.testing.assert_array_equal(got["kernel"][0], got["plain"][0])
    assert got["kernel"][1] == got["plain"][1]


def test_turbo_card_rescue_on_gpu_matches_kd_rescue(gpu_pore, gpu_genome,
                                                    cuda_device):
    """A GPU turbo mapper's rescue searches its chunks on the card, and its
    records, the rescued reads' among them, equal those of a mapper whose
    rescue searches the k-d tree (tests/test_torch_rescue_search.py's
    setup: S=16, K=1, so that reads overflow).  With buffers too small for
    its first chunk, a card search grows them and answers as the tree."""
    from sigmap_tpu_torch.config import RuntimeConfig
    from sigmap_tpu_torch.config import SigmapConfig as Cfg
    from sigmap_tpu_torch.index.build import build_index
    from sigmap_tpu_torch.io.fasta import ReferenceSequence
    from sigmap_tpu_torch.io.signals import ReadSignal, dac_to_pa
    from sigmap_tpu_torch.mapping import rescue as R
    from sigmap_tpu_torch.mapping import turbo as T
    from sigmap_tpu_torch.synth import simulate_reads

    cfg = Cfg(runtime=RuntimeConfig(read_batch=32, num_threads=2))
    idx = build_index([ReferenceSequence(n, c) for n, c in gpu_genome],
                      gpu_pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    reads = simulate_reads(gpu_pore, gpu_genome, 32, seed=5,
                           read_bases=2000)
    signals = [ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                          dac_to_pa(r.raw, r.digitisation, r.range,
                                    r.offset)) for r in reads]
    params = T.TurboParams(S=16, K=1, RING=64, TILE=256)
    out = {}
    for card in (True, False):
        mapper = T.TurboMapper(idx, cfg, params, device=cuda_device)
        mapper._card_rescue = card
        try:
            before = LAUNCHES["rescue_search"]
            recs = mapper.streaming_map(signals)
            out[card] = (_records_without_mt(recs), mapper.n_rescued,
                         mapper.n_rescue_search_device,
                         LAUNCHES["rescue_search"] - before,
                         mapper._card_search())
        finally:
            mapper.close()
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1] > 0
    assert out[True][2] > 0 and out[True][3] >= out[True][2]
    assert out[False][2] == out[False][3] == 0

    # a chunk of 64 index windows with noise, through buffers of 64 words
    card = out[True][4]
    W = np.lib.stride_tricks.sliding_window_view(idx.values, idx.dim)
    rng = np.random.default_rng(3)
    q = (W[rng.integers(0, idx.n_windows, 64)]
         + rng.normal(0, 0.1, (64, idx.dim))).astype(np.float32)
    radius = cfg.mapping.search_radius
    want = mapper._get_oracle().tree.radius_batch(q, radius, per_cap=5000)
    small = R.CardSearch(card.store, idx, cuda_device)
    R_in, R_out = R.IN_WORDS, R.OUT_WORDS
    R.IN_WORDS = R.OUT_WORDS = 64
    try:
        got = small(q, radius, per_cap=5000)
    finally:
        R.IN_WORDS, R.OUT_WORDS = R_in, R_out
    assert got is not None and len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    qa = np.repeat(np.arange(64), want[2])
    og, ow = np.lexsort((got[0], qa)), np.lexsort((want[0], qa))
    np.testing.assert_array_equal(got[0][og], want[0][ow])
    np.testing.assert_array_equal(got[1][og].view(np.int32),
                                  want[1][ow].view(np.int32))
    assert small._bufs[1].numel() >= 1 + 64 + 3 * len(want[0])


# --- B5 (sdtw) --------------------------------------------------------------

# chip_smoke.sdtw_adversarial's cases (tests/test_torch_sdtw.py holds the
# list to it), and the ragged, uniform and long pairs ("pairs")
SDTW_CASES = ("pairs", "edges_4_2_2", "edges_8_3_1", "edges_2_2_4",
              "edges_8_1_8", "ragged", "long_query", "empty", "regimes",
              "ties")


@pytest.mark.parametrize("case", SDTW_CASES)
def test_sdtw_kernel_matches_plain_on_gpu(cuda_device, case):
    """B5 == sdtw_plain exactly (best and end): ragged and uniform pairs,
    and queries up to 12,000 samples (plan splits them over 8 CTAs); q_len
    at every band and pass edge +-1 of four launches; a ragged batch;
    queries longer than their targets; t_len 0 and q_len 0; pairs of one
    band, several bands, both CTAs of a cluster and three passes in one
    call; ties on many target positions (the first wins)."""
    from sigmap_tpu_torch.ops.sdtw_kernel import sdtw, sdtw_plain

    if case == "pairs":
        rng = np.random.default_rng(0)
        B, T, Q = 6, 700, 12000
        tl = rng.integers(1, T + 1, B).astype(np.int32)
        ql = rng.integers(1, Q + 1, B).astype(np.int32)
        tl[0], ql[1] = 0, 0
        runs = [(None, c) for c in (ragged_pairs(), uniform_pairs())] + [
            (None, (rng.normal(0, 1, (B, T)).astype(np.float32), tl,
                    rng.normal(0, 1, (B, Q)).astype(np.float32), ql))]
    else:
        runs = [sdtw_adversarial()[case]]
    for launch, arrays in runs:
        args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
        before = LAUNCHES["sdtw"]
        kb, ke = sdtw(*args, launch=launch)
        torch.cuda.synchronize()
        assert LAUNCHES["sdtw"] == before + 1
        pb, pe = sdtw_plain(*args)
        assert torch.equal(kb, pb) and torch.equal(ke, pe)


def test_sdtw_refused_launch_raises(cuda_device):
    """A launch outside the kernel's shapes raises; nothing falls back to
    sdtw_plain."""
    from sigmap_tpu_torch.ops.sdtw_kernel import make_plan, sdtw

    args = [torch.from_numpy(a).to(cuda_device) for a in uniform_pairs()]
    B, T, Q = args[0].shape[0], args[0].shape[1], args[2].shape[1]
    before = LAUNCHES["sdtw"]
    # no instantiation of 16 rows a lane; a cluster over 8 CTAs
    for kw in (dict(rows=16), dict(cluster=16)):
        with pytest.raises(RuntimeError, match="sdtw"):
            sdtw(*args, launch=make_plan(B, T, Q, 2, 1)._replace(**kw))
    assert LAUNCHES["sdtw"] == before


# --- device paths against their CPU runs -------------------------------------

def test_search_on_gpu_matches_cpu(search_setup, cuda_device):
    from sigmap_tpu_torch.mapping import seeding as P

    idx, q8 = search_setup
    for kw in (SEARCH_KW, SEARCH_TIGHT):
        out = []
        for dev in ("cpu", cuda_device):
            pd = P.DeviceIndex.from_host(idx, radius=SEARCH_RADIUS,
                                         device=dev, **kw)
            seeds, valid, n_tiles = P.pad_seeds(q8, pd.params)
            out.append(P.flatten_matches(
                P.search_flat(pd, seeds, valid, n_tiles), pd.params))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)


def test_mapper_on_gpu_matches_cpu(driver_setup, cuda_device):
    """The exact engine on the card against its CPU run: every record field
    and tag exact (the feature sums are added in f64 on both devices,
    signal/events.py:_row_sum)."""
    from sigmap_tpu_torch.mapping import driver as port

    idx, _, signals = driver_setup
    for mode in ("streaming_map", "map_reads"):
        before = LAUNCHES["peaks"]
        got = getattr(port.Mapper(idx, DRIVER_CFG, device=cuda_device),
                      mode)(signals)
        assert LAUNCHES["peaks"] > before
        want = getattr(port.Mapper(idx, DRIVER_CFG, device="cpu"),
                       mode)(signals)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            g["tags"] = [t for t in g["tags"].split("\t") if t[:2] != "mt"]
            w["tags"] = [t for t in w["tags"].split("\t") if t[:2] != "mt"]
            assert g == w


def test_turbo_overlap_on_gpu_matches_sequential(driver_setup, cuda_device):
    """The turbo mapper on the card over four batches (8 reads, read batch
    2): batch N+1 prepared on the side stream while batch N maps (set on:
    the batches are below OVERLAP_MIN_BATCH) gives every record field and
    tag but mt: as each batch prepared inline on the caller's stream,
    exactly; B1 runs once a batch either way."""
    from sigmap_tpu_torch.config import RuntimeConfig, SigmapConfig
    from sigmap_tpu_torch.mapping import turbo as T

    idx, _, signals = driver_setup
    cfg = SigmapConfig(runtime=RuntimeConfig(read_batch=2))
    mapper = T.TurboMapper(idx, cfg, T.TurboParams(S=256, K=16, RING=64,
                                                   TILE=256),
                           device=cuda_device)
    got = {}
    try:
        for overlap in (True, False, True):
            mapper._overlap_batches = overlap
            before = LAUNCHES["peaks"]
            recs = mapper.streaming_map(signals)
            torch.cuda.synchronize()
            assert LAUNCHES["peaks"] == before + 4
            recs = [dataclasses.asdict(r) for r in recs]
            for r in recs:
                r["tags"] = [t for t in r["tags"].split("\t")
                             if t[:2] != "mt"]
            got.setdefault(overlap, recs)
            assert recs == got[overlap]
    finally:
        mapper.close()
    assert len(got[True]) == len(signals)
    assert got[True] == got[False]


def _records_without_mt(recs):
    out = [dataclasses.asdict(r) for r in recs]
    for r in out:
        r["tags"] = [t for t in r["tags"].split("\t") if t[:3] != "mt:"]
    return out


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap",
                                                        "inline"])
def test_turbo_graphs_on_gpu_match_eager(driver_setup, cuda_device,
                                         overlap):
    """streaming_map with the rounds and heads replayed from CUDA graphs
    gives the records of the same mapper run op by op, every field and tag
    but mt:, exactly, with the next batch prepared on the side stream while
    a batch maps and with each batch prepared inline (8 reads, read batch
    2: four batches, so graphs are replayed across batches); every graph
    replays, and its pool's size is reported; a profiled pass shows B3 and
    B4 once a round."""
    from sigmap_tpu_torch.config import RuntimeConfig, SigmapConfig
    from sigmap_tpu_torch.mapping import turbo as T

    idx, _, signals = driver_setup
    cfg = SigmapConfig(runtime=RuntimeConfig(read_batch=2))
    mapper = T.TurboMapper(idx, cfg, T.TurboParams(S=256, K=16, RING=64,
                                                   TILE=256),
                           device=cuda_device)
    try:
        assert mapper._graphs
        mapper._overlap_batches = overlap
        mapper._graphs = False
        want = _records_without_mt(mapper.streaming_map(signals))
        mapper._graphs = True
        for _ in range(2):
            got = mapper.streaming_map(signals)
            torch.cuda.synchronize()
            assert _records_without_mt(got) == want
        # the profiler's trace holds the kernels each replay launched: B3
        # and B4 once a round
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA],
                acc_events=True) as prof:
            got = mapper.streaming_map(signals)
            torch.cuda.synchronize()
        assert _records_without_mt(got) == want
        rounds = len(mapper.last_pass["round_host"])
        counts = {k: sum(e.count for e in prof.key_averages() if k in e.key)
                  for k in ("sweep_kernel", "chain_fused_kernel")}
        assert counts == dict(sweep_kernel=rounds,
                              chain_fused_kernel=rounds), (counts, rounds)
        stats = mapper.graph_stats()
    finally:
        mapper.close()
    print(json.dumps(stats))
    assert len(want) == len(signals)
    assert {s["graph"].split()[0] for s in stats} == {"round", "head"}
    for s in stats:
        assert s["captures"] == 1 and s["replays"] > 0, s
        assert s["pool_mib"] > 0, s


def test_graph_replays_add_their_captured_launches(driver_setup,
                                                   cuda_device):
    """A graph's capture launches nothing and counts nothing; each replay
    adds to LAUNCHES the launches its capture recorded: B3 and B4 once a
    round, B1 and B2 once a head block (a batch's 12 chunk rows in three
    head blocks of 4, one head graph).  The first call of each graph runs
    its body eagerly, and its launches count as they happen."""
    from sigmap_tpu_torch import _build
    from sigmap_tpu_torch.config import RuntimeConfig, SigmapConfig
    from sigmap_tpu_torch.mapping import turbo as T

    idx, _, signals = driver_setup
    B = 4
    mapper = T.TurboMapper(idx, SigmapConfig(runtime=RuntimeConfig(
        read_batch=B)), T.TurboParams(S=256, K=16, RING=64, TILE=256),
        device=cuda_device)
    mapper._head_block = 4
    names = ("peaks", "compress_keep", "sweep", "chain_fused")
    try:
        NC = mapper.upload_batch(signals[:B])[0].shape[1]
        blocks = len(T.head_blocks(B * NC, 4))
        assert (NC, blocks) == (3, 3)
        graph = None
        for call in range(3):
            before = {k: LAUNCHES[k] for k in names}
            prep = mapper.prepare_batch(signals[:B])
            feats, counts = prep.feats, prep.counts
            if graph is None:
                graph = mapper._round_graph(B, feats.shape[-1])
                graph.start(prep.n_full_d)
            graph.run(feats[:, 0], counts[:, 0])
            torch.cuda.synchronize()
            grew = {k: LAUNCHES[k] - before[k] for k in names}
            assert grew == dict(peaks=blocks, compress_keep=blocks, sweep=1,
                                chain_fused=1), (call, grew)
        (head,) = mapper._head_graphs.values()
        assert head.parts[0].launches == dict(peaks=1, compress_keep=1)
        assert graph.parts[0].launches == dict(sweep=1, chain_fused=1)
        # the head graph's first block ran eagerly, every later one replays
        assert head.parts[0].replays == 3 * blocks - 1
        assert graph.parts[0].replays == 2
        assert getattr(_build._capture, "launches", None) is None
    finally:
        mapper.close()


def test_head_memory_does_not_grow_with_chunks(driver_setup, cuda_device):
    """The batch head in blocks of 8 rows at B=4 through one mapper's head
    graphs at NC 1, 2, 4, 8 and 16 (4 to 64 rows): it equals the whole
    batch's head run eagerly, exactly (NaN where both are NaN), and from
    NC 2 on the head graphs are the same two (blocks of 4 and 8) with the
    same pools."""
    from sigmap_tpu_torch.config import RuntimeConfig, SigmapConfig
    from sigmap_tpu_torch.mapping import turbo as T

    B, Cs = 4, 4000
    cfg = SigmapConfig(runtime=RuntimeConfig(read_batch=B))
    mapper = T.TurboMapper(driver_setup[0], cfg, T.TurboParams(S=256, K=16,
                                                             RING=64,
                                                             TILE=256),
                           device=cuda_device)
    mapper.close()
    mapper._head_block = 8
    args = (mapper.p, cfg.event, cfg.mapping.compress_delta)
    rng = np.random.default_rng(3)
    pools = []
    for NC in (1, 2, 4, 8, 16):
        q = torch.from_numpy(rng.integers(
            20000, 40000, (B, NC, Cs)).astype(np.int32)).to(cuda_device)
        qoff = torch.from_numpy(rng.uniform(-2000, 0, B).astype(
            np.float32)).to(cuda_device)
        qscale = torch.full((B,), 0.1, device=cuda_device)
        n_full = torch.from_numpy(rng.integers(0, NC + 1, B).astype(
            np.int32)).to(cuda_device)
        ins = (q, qoff, qscale, n_full)
        for _ in range(2):          # an eager first block, then replays
            got = T.batch_features(*ins, *args, block=8,
                                   run_block=mapper._run_head_block)
        want = T.batch_features(*ins, *args, block=B * NC)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        pools.append(sorted((g.name, g.stats()["pool_mib"])
                            for g in mapper._head_graphs.values()))
    print(json.dumps(pools))
    assert [g for g, _ in pools[1]] == [f"head rows=4 Cs={Cs}",
                                        f"head rows=8 Cs={Cs}"]
    assert all(p == pools[1] for p in pools[1:])


# a body that reads a device value to the host, captured two ways: by
# graphs.capture itself, and by a head graph whose rows_features does so
HOST_READ_IN_CAPTURE = {
    "capture": """
x = torch.ones(4, device=dev)
G.capture(lambda: (x * 2).sum().item(), dev)
""",
    "head_graph": """
eager = G.rows_features


def reads_back(*args):
    out = eager(*args)
    out[1].sum().item()
    return out


G.rows_features = reads_back
head = G.HeadGraph(4, 4000, T.TurboParams(), EventDetectorConfig(), 0.1, dev)
q = torch.randint(20000, 40000, (4, 4000), dtype=torch.int32).to(dev)
args = (q, torch.zeros(4, device=dev), torch.full((4,), 0.01, device=dev),
        torch.full((4,), 4000, dtype=torch.int32, device=dev))
try:
    head.run(*args)
finally:
    print("graphs left behind:", len(head.parts))
""",
}
HOST_READ_PRELUDE = """
import torch
from sigmap_tpu_torch.config import EventDetectorConfig
from sigmap_tpu_torch.mapping import graphs as G, turbo as T

dev = torch.device("cuda")
"""


@pytest.mark.parametrize("body", sorted(HOST_READ_IN_CAPTURE))
def test_host_read_in_a_capture_raises(cuda_device, body):
    """A body that reads a device value to the host cannot be captured: the
    capture raises, and a head graph whose body does so raises from run()
    after its eager first run, leaving no graph, instead of going on
    eagerly.  Each in a process of its own: a broken-off capture leaves
    PyTorch's allocator and generator in capture mode."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", HOST_READ_PRELUDE + HOST_READ_IN_CAPTURE[body]],
        cwd=root, capture_output=True, text=True, timeout=300)
    print(r.stdout, r.stderr[-2000:])
    assert r.returncode != 0
    # a RuntimeError (torch.AcceleratorError in recent versions) naming the
    # capture
    raised = [x for x in r.stderr.splitlines()
              if re.match(r"[\w.]*Error: ", x)]
    assert raised and "captur" in raised[-1], r.stderr[-2000:]
    if body == "head_graph":
        assert "graphs left behind: 0" in r.stdout


@pytest.mark.parametrize("NC", [1, 4])
def test_quantize_on_gpu_matches_cpu(driver_setup, cuda_device, NC):
    """The transport quantization's device half on the card, from a pinned
    buffer, equals its run on the CPU (which tier-1 holds to the JAX
    package's host quantization) on every branch, exactly."""
    from sigmap_tpu_torch.mapping import turbo as T

    reads = quantize_reads(driver_setup[2])
    B, Cs = len(reads) + 3, 4000
    pa, L, scale, off, n_full = T.stage_batch(reads, B, NC, Cs, 30, pin=True)
    assert pa.is_pinned()
    got = T.quantize(pa.to(cuda_device, non_blocking=True), L, scale, off)
    want = T.quantize(pa.clone(), L, scale, off)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


def test_shard_mapper_in_a_one_rank_nccl_group(driver_setup, cuda_device,
                                              tmp_path):
    """The sharded mapper at mesh (1, 1) in a one-rank NCCL group, in a
    process of its own (tests/_torch_shard_worker.py), gives the
    single-device mapper's records on the card apart from mt:, reads whose
    capacity overflowed excepted, and rescues as many reads; and the
    one-process emulation of the mesh's records (chip_smoke's
    threaded_shard_map) apart from mt: with no read excepted."""
    from sigmap_tpu_torch.config import RuntimeConfig, SigmapConfig
    from sigmap_tpu_torch.io.paf import PAFRecord
    from sigmap_tpu_torch.io.signals import load_all_read_signals
    from sigmap_tpu_torch.io.slow5 import (COMP_ZLIB, SIGCOMP_NONE,
                                           write_blow5)
    from sigmap_tpu_torch.mapping import turbo as T

    idx, reads, _ = driver_setup
    prefix = str(tmp_path / "idx")
    idx.save(prefix)
    sig = tmp_path / "signals"
    sig.mkdir()
    write_blow5(str(sig / "reads.blow5"),
                [dict(read_id=r.read_id, raw=r.raw,
                      digitisation=r.digitisation, range=r.range,
                      offset=r.offset) for r in reads],
                rec_comp=COMP_ZLIB, sig_comp=SIGCOMP_NONE)
    signals = load_all_read_signals(str(sig))
    params = dict(S=256, K=16, RING=64, TILE=256)
    mapper = T.TurboMapper(idx, SigmapConfig(runtime=RuntimeConfig(
        read_batch=len(signals))), T.TurboParams(**params),
        device=cuda_device)
    try:
        want = mapper.streaming_map(signals)
    finally:
        mapper.close()
    outs, _ = run_shard_ranks(
        (1, 1), str(tmp_path / "ranks"),
        ["--backend", "nccl", "--device", "cuda", "--timeout", "120",
         "--index", prefix, "--signals", str(sig), "--read-batch",
         str(len(signals)), "--params", json.dumps(params)], wall_s=300)
    got = [PAFRecord(**r) for r in outs[0]["records"]]
    assert [r.read_id for r in got] == list(range(len(signals)))
    shard_differences("mesh (1, 1), NCCL", want, mapper.last_pass, got,
                      outs[0])
    shard_equal("mesh (1, 1), NCCL", *threaded_shard_map(
        idx, mapper.cfg, T.TurboParams(**params), 1, signals, cuda_device),
        got, outs[0])
    # its round is two graphs around the merge, and it maps as the same
    # mapper run op by op does
    (round_graph,) = [g for g in outs[0]["graphs"]
                      if g["graph"].startswith("round")]
    assert round_graph["captures"] == 2 and round_graph["replays"] > 0
    eager, _ = run_shard_ranks(
        (1, 1), str(tmp_path / "eager"),
        ["--backend", "nccl", "--device", "cuda", "--timeout", "120",
         "--index", prefix, "--signals", str(sig), "--read-batch",
         str(len(signals)), "--params", json.dumps(params), "--eager"],
        wall_s=300)
    assert eager[0]["graphs"] == []
    shard_equal("mesh (1, 1), NCCL, graphs against eager",
                [PAFRecord(**r) for r in eager[0]["records"]], eager[0],
                got, outs[0])


def test_align_modes_on_gpu_match_cpu(debug_work, cuda_device):
    from sigmap_tpu_torch import debug_modes as tdm

    ref, pore, sig, _ = debug_work
    for mode in ("dtw_align", "cwt_align"):
        before = LAUNCHES["sdtw"]
        got = getattr(tdm, mode)(ref, pore, sig, out=io.StringIO(),
                                 device=cuda_device)
        torch.cuda.synchronize()
        assert LAUNCHES["sdtw"] > before
        assert got == getattr(tdm, mode)(ref, pore, sig, out=io.StringIO(),
                                         device="cpu")
