"""The reference's index and tile store builders (plain torch, on the
reference's device) against the numpy builders they replaced
(``numpy_oracle``), bit for bit; its 64-bit window metadata; and genomes
past the port's packed meta (more than 32 sequences, positions past
2^25), mapped to their truths.  The ``card`` cases run with ``python -m
pytest -m card -s benchmark/tests`` on a machine with a card."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import synthgen, workload
from benchmark.reference import ReadIn, Reference, index, nc_bucket, rounds
from benchmark.reference import sweep_index
from benchmark.reference.config import SigmapConfig
from benchmark.reference.rescue import Undecided
from benchmark.tests import numpy_oracle

CFG = SigmapConfig()
RADIUS = CFG.mapping.search_radius
INDEX_FIELDS = ("values", "win_group", "win_pos", "cell_keys", "cell_starts",
                "perm")
STORE_FIELDS = ("tiles", "cum", "rot", "mu", "origin")


def low_complexity(n: int, rng):
    """Random bases with a 400-base motif repeated 150 times (its k-mers
    pass the mask's frequency) and poly-A runs of 20 to 60 bases (flat
    stretches of expected signal, whose unmasked edges dedup drops)."""
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    motif = rng.integers(0, 4, size=400, dtype=np.uint8)
    for s in rng.choice(n // 400 - 1, 150, replace=False):
        codes[s * 400: s * 400 + 400] = motif
    for s in rng.choice(n - 60, n // 2000, replace=False):
        codes[s: s + rng.integers(20, 61)] = 0
    return codes


def genome_of(case: str, seed: int):
    rng = synthgen.rng_for(seed, "genome")
    if case == "one":
        return synthgen.random_contigs([("a", 150_000)], rng)
    if case == "contigs":
        return synthgen.random_contigs(
            [("a", 70_000), ("b", 40_000), ("c", 25), ("d", 9_000)], rng)
    return [("a", low_complexity(120_000, rng)),
            ("b", rng.integers(0, 4, size=30_000, dtype=np.uint8))]


def assert_same_as_oracle(genome, pore, tile: int, dev):
    """Every array of the torch builders on ``dev`` equals the numpy
    oracle's, dtype and all; the 64-bit meta decodes to the 32-bit meta's
    group and position."""
    want = numpy_oracle.build(genome, pore, CFG.index, RADIUS)
    want_sw = numpy_oracle.build_sweep(want, RADIUS, tile=tile)
    got = index.build(genome, pore, CFG.index, RADIUS, dev)
    got_sw = sweep_index.build(got, RADIUS, tile=tile)
    for name in INDEX_FIELDS:
        a, b = getattr(want, name), getattr(got, name).cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in STORE_FIELDS:
        a, b = getattr(want_sw, name), getattr(got_sw, name).cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got_sw.radixes == want_sw.radixes
    assert got_sw.cell_width == want_sw.cell_width
    meta = got_sw.meta.cpu().numpy()
    assert meta.shape == want_sw.meta.shape
    assert np.array_equal(meta >> 32, want_sw.meta >> 25)
    assert np.array_equal(meta & 0xFFFFFFFF, want_sw.meta & (2**25 - 1))
    return want


@pytest.mark.parametrize("case,seed", [
    ("one", 2**31 + 17), ("one", 5), ("contigs", 2**31 + 91),
    ("repeats", 2**31 + 3), ("repeats", 44)])
def test_torch_builders_equal_the_numpy_oracle(case, seed):
    pore = synthgen.synthetic_pore()
    genome = genome_of(case, seed)
    assert_same_as_oracle(genome, pore, 1024, "cpu")
    if case == "repeats":
        masked, longest = mask_and_dedup_runs(genome, pore)
        assert masked > 1000 and longest >= 2, (masked, longest)


def mask_and_dedup_runs(genome, pore):
    """The windows the oracle masks, and its longest run of dedup drops
    (consecutive unmasked windows of a stream)."""
    dim = CFG.index.dimension
    seqs = [(c, synthgen.revcomp(c)) for _, c in genome]
    masks = numpy_oracle.kmer_masks(seqs, dim + pore.k - 1,
                                    CFG.index.mask_frequency)
    longest, prev = 0, None
    for strand in (0, 1):
        for (codes, neg), pair in zip(seqs, masks):
            sig = numpy_oracle.zscore_f64(synthgen.expected_signal(
                pore, (codes, neg)[strand]))
            n_win = len(sig) - dim + 1
            if n_win <= 0:
                continue
            kept, prev = numpy_oracle.dedup(
                sig[:n_win], pair[strand], CFG.index.dedup_delta, prev)
            drop = np.ones(n_win, bool)
            drop[kept] = False
            run = 0
            for dropped in drop[~pair[strand]]:
                run = run + 1 if dropped else 0
                longest = max(longest, run)
    return sum(int(m.sum()) for pair in masks for m in pair), longest


def oracle_dedup(streams, delta):
    """numpy_oracle.dedup over (values, masked) streams in order."""
    prev, keep = None, []
    for vals, masked in streams:
        kept, prev = numpy_oracle.dedup(vals, masked, delta, prev)
        k = np.zeros(len(vals), bool)
        k[kept] = True
        keep.append(k[~masked])
    return np.concatenate(keep)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dedup_equals_the_oracle_on_runs_and_stream_starts(seed):
    """Streams of values on a grid a little finer than delta (runs of
    drops, ramps whose neighbours all lie within delta), some with their
    first position masked and their first window within delta of the
    last kept value (a stream that starts on a drop)."""
    rng = np.random.default_rng(seed)
    delta = 0.01
    streams = []
    last = np.float32(0)
    for s in range(12):
        n = int(rng.integers(1, 400))
        steps = rng.choice([-0.012, -0.006, -0.003, 0.0, 0.003, 0.006,
                            0.012, 0.5], n)
        vals = (np.float32(last) + np.cumsum(steps)).astype(np.float32)
        masked = rng.random(n) < 0.2
        if s % 3 == 1:
            masked[0] = True
            vals[1:] += last - vals[1]
        streams.append((vals, masked))
        last = vals[~masked][-1] if (~masked).any() else last
    want = oracle_dedup(streams, delta)
    u = torch.from_numpy(np.concatenate([v[~m] for v, m in streams]))
    forced = torch.from_numpy(np.concatenate(
        [np.flatnonzero(~m) == 0 for _, m in streams]))
    forced[:1] = True
    got = index.dedup(u, forced, delta).numpy()
    assert np.array_equal(got, want)
    # runs of two or more drops, and a stream's first window dropped
    drops = np.flatnonzero(~want)
    assert (np.diff(drops) == 1).any()
    starts = np.cumsum([0] + [int((~m).sum()) for _, m in streams[:-1]])
    assert (~want[starts[1:]]).any()


def test_meta_decodes_as_the_32_bit_form_where_it_fits():
    """(group << 32) | position sorts and decodes as (group << 25) |
    position wherever that fits (groups below 64, positions below 2^25),
    through the rounds' own decode; past it, groups and positions come
    back whole."""
    rng = np.random.default_rng(7)
    B, S, K = 3, 4, 5
    g = rng.integers(0, 64, B * S * K)
    p = rng.integers(0, 2**25, B * S * K)
    p[:4] = [0, 1, 2**25 - 1, 2**24]
    m32 = (g << 25) | p
    m64 = (g << rounds.META_POS_BITS) | p
    assert np.array_equal(np.argsort(m32, kind="stable"),
                          np.argsort(m64, kind="stable"))
    wrote = torch.full((B * S,), K, dtype=torch.int32)
    qpos = torch.zeros((B, S), dtype=torch.int32)
    d2 = torch.zeros((B * S, K))

    def decode(m):
        n_t, _, _, n_g = rounds.anchors_qpos_major(
            torch.from_numpy(m).reshape(B * S, K), d2, wrote, qpos, B, S, K)
        return n_t, n_g

    n_t, n_g = decode(m64)
    assert n_t.dtype == n_g.dtype == torch.int32
    assert torch.equal(n_t, torch.from_numpy(
        (m32 & (2**25 - 1)).astype(np.int32)).reshape(B, S * K).t())
    assert torch.equal(n_g, torch.from_numpy(
        (m32 >> 25).astype(np.int32)).reshape(B, S * K).t())
    big_g = rng.integers(64, 4096, B * S * K)
    big_p = rng.integers(2**25, 2**31, B * S * K)
    n_t, n_g = decode((big_g << 32) | big_p)
    assert torch.equal(n_t, torch.from_numpy(big_p.astype(np.int32))
                       .reshape(B, S * K).t())
    assert torch.equal(n_g, torch.from_numpy(big_g.astype(np.int32))
                       .reshape(B, S * K).t())


def tile_of(starts, cums, s: int):
    """The plain sweep's per-step decode that ``rounds.step_schedule``
    replaced: flat step s -> each block's tile."""
    t = starts[:, 0] + s
    for oo in range(1, starts.shape[1]):
        t = torch.where(cums[:, oo] <= s, starts[:, oo] + (s - cums[:, oo]),
                        t)
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_step_schedule_equals_the_per_step_decode(seed):
    """Blocks of 27 offsets, a third of them empty: each step's blocks
    (those with more steps than s, ascending) and tiles."""
    g = torch.Generator().manual_seed(seed)
    G, NO = 50, 27
    tcnt = torch.randint(0, 6, (G, NO), generator=g)
    tcnt[torch.rand((G, NO), generator=g) < 0.33] = 0
    starts = torch.randint(0, 1000, (G, NO), generator=g)
    cums = torch.cat([torch.zeros((G, 1), dtype=torch.int64),
                      torch.cumsum(tcnt, 1)], dim=1)
    blockmeta = torch.cat([starts, cums], dim=1).t().to(torch.int32)
    blocks, tiles, bounds = rounds.step_schedule(blockmeta)
    total = cums[:, NO]
    assert len(bounds) - 1 == int(total.max())
    for s in range(len(bounds) - 1):
        act = torch.nonzero(total > s).squeeze(1)
        assert torch.equal(blocks[bounds[s]: bounds[s + 1]], act)
        assert torch.equal(tiles[bounds[s]: bounds[s + 1]],
                           tile_of(starts[act], cums[act], s))


def reads_of(pore, genome, spans, n: int, rng, prefix: str):
    """``n`` on-target 3,000-base reads drawn from ``spans``, each (contig
    index, start, end) of ``genome``, with their truths in the genome's
    own coordinates."""
    out = []
    for si, (ci, lo, hi) in enumerate(spans):
        part = [(genome[ci][0], genome[ci][1][lo:hi])]
        _, pas, truths = synthgen.simulate_pool(
            pore, part, None, np.full(n, 3000), np.zeros(n, bool), rng,
            8.89, 1.2)
        for i, (pa, t) in enumerate(zip(pas, truths)):
            rid = f"{prefix}{si}_{i}"
            out.append((ReadIn(rid, pa, synthgen.DIGITISATION,
                               synthgen.DAC_RANGE, synthgen.DAC_OFFSET, 0),
                        synthgen.Truth(rid, ci, t.ref_start + lo,
                                       t.ref_end + lo, t.strand, True)))
    return out


def map_reads(ref, reads):
    """The rounds on every read as one batch (of one chunk bucket), the
    rescue on those it sends there: (hits for score_hits, each hit's MAPQ,
    rescued, undecided, seconds of the rounds, seconds of the rescue)."""
    nc = nc_bucket([len(r.pa) for r, _ in reads], CFG)
    for r, _ in reads:
        r.nc = nc
    t = time.perf_counter()
    outs = ref.map_rounds([r for r, _ in reads])
    t_rounds = time.perf_counter() - t
    t = time.perf_counter()
    hits, mapq, rescued, undecided = [], {}, 0, 0
    for (r, _), (rec, _, resc) in zip(reads, outs):
        if resc:
            rescued += 1
            try:
                rec = ref.rescue(r)
            except Undecided:
                undecided += 1
                continue
        if rec.fragment_length > 0:
            hits.append((r.name, "+" if rec.direction == 1 else "-",
                         rec.ref_index, rec.fragment_start,
                         rec.fragment_start + rec.fragment_length))
            mapq[r.name] = rec.mapq
    return (hits, mapq, rescued, undecided, t_rounds,
            time.perf_counter() - t)


def params():
    cell = workload.load_cell(workload.load_benchmark(), "ecoli.short")
    return cell.config["turbo_params"]


def test_more_than_32_sequences_map_to_their_truths():
    """40 sequences (groups up to 79, past the 32-bit meta's 63): on-target
    reads from every sequence and from the last eight map to their
    truths through the rounds."""
    seed = 2**31 + 40
    rng = synthgen.rng_for(seed, "genome")
    genome = synthgen.random_contigs(
        [(f"s{i}", 6_000 + 150 * i) for i in range(40)], rng)
    pore = synthgen.synthetic_pore()
    ref = Reference(genome, pore, params(), "cpu")
    assert int(ref.idx.win_group.max()) == 79
    pool = synthgen.rng_for(seed, "pool")
    reads = (reads_of(pore, genome, [(32 + i, 0, len(genome[32 + i][1]))
                                     for i in range(8)], 2, pool, "late")
             + reads_of(pore, genome, [(i, 0, len(genome[i][1]))
                                       for i in range(0, 32, 4)], 1, pool,
                        "early"))
    hits = map_reads(ref, reads)[0]
    mapped, correct = synthgen.score_hits(hits, [t for _, t in reads])
    assert correct == mapped >= 20, (mapped, correct, len(reads))
    late = {h[0] for h in hits if h[0].startswith("late")}
    assert len(late) >= 12, late


@pytest.mark.card
@pytest.mark.parametrize("config", ["ecoli-k12", "yeast-s288c"])
def test_torch_builders_equal_the_oracle_on_the_card(card, config):
    """At the configuration's own size, for one seed."""
    bench = workload.load_benchmark()
    cell = next(w["name"] for w in bench["workloads"]
                if w["config"] == config)
    c = workload.load_cell(bench, cell)
    genome = synthgen.random_contigs(c.config["contigs"],
                                     synthgen.rng_for(2**31 + 171, "genome"))
    pm = c.config["pore_model"]
    pore = synthgen.synthetic_pore(pm["k"], pm["seed"])
    torch.cuda.synchronize(card)
    assert_same_as_oracle(genome, pore, c.config["turbo_params"]["TILE"],
                          card)


SCALE_BASES = 111_000_000
SCALE_BIG = 40_000_000


def scale_contigs():
    """60 sequences of 111,000,000 bases: one of 40,000,000 (positions
    past 2^25 on both strands), then 59 scaffolds of 40,113 to 2,406,779
    bases in proportion 1..59."""
    rest = SCALE_BASES - SCALE_BIG
    lens = [rest * w // 1770 for w in range(1, 60)]
    lens[-1] += rest - sum(lens)
    return [("big", SCALE_BIG)] + [(f"s{i}", n) for i, n in enumerate(lens)]


@pytest.mark.card
def test_genome_scale_reference_on_the_card(card):
    """The reference of a 111 Mb genome in 60 sequences builds on the card;
    on-target reads, 16 from anywhere and 16 from each end of the 40 Mb
    sequence (whose strands' positions pass 2^25), map to their truths:
    every read mapped with MAPQ 60, and on each strand a read past 2^25.
    At 220 M windows every seed's matches pass its 8 slots, and a window's
    11-mer recurs some 50 times over the index at nearly the same values,
    copies that compete with the true window for those slots: many reads
    go to the rescue (undecided past the exact engine's cap of 5,000
    matches) or map through 3 or 4 anchors at a low MAPQ, where a wrong
    place can win.  Times are printed, not asserted."""
    seed = 2**31 + 111
    contigs = scale_contigs()
    assert sum(n for _, n in contigs) == SCALE_BASES and len(contigs) == 60
    genome = synthgen.random_contigs(contigs,
                                     synthgen.rng_for(seed, "genome"))
    pore = synthgen.synthetic_pore()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(card)
    ref = Reference(genome, pore, params(), card)
    built = dict(ref.seconds)
    peak = torch.cuda.max_memory_allocated(card)
    pool = synthgen.rng_for(seed, "pool")
    spans = [(i, 0, n) for i, (_, n) in enumerate(contigs)]
    anywhere = reads_of(pore, genome, [spans[i] for i in pool.choice(
        len(spans), 16, replace=False)], 1, pool, "any")
    ends = reads_of(pore, genome, [(0, 0, 6_000_000),
                                   (0, SCALE_BIG - 6_000_000, SCALE_BIG)],
                    16, pool, "end")
    reads = anywhere + ends
    hits, mapq, rescued, undecided, t_rounds, t_rescue = map_reads(ref,
                                                                   reads)
    truths = [t for _, t in reads]
    right = {h[0] for h in hits if synthgen.score_hits([h], truths)[1]}
    strand = {t.read_id: t.strand for t in truths}
    # a strand's own position passes 2^25: forward reads at the end (end1),
    # reverse reads at the start (end0) of the 40 Mb sequence
    past = {s: [n for n in right if n.startswith(f"end{s}")
                and strand[n] == s] for s in (0, 1)}
    print("scale: " + json.dumps(dict(
        device=torch.cuda.get_device_name(card), windows=ref.idx.n_windows,
        index_s=built["index"], tile_store_s=built["tile_store"],
        build_peak_bytes=peak,
        peak_bytes=torch.cuda.max_memory_allocated(card),
        reads=len(reads), mapped=len(hits), right=len(right),
        mapq=mapq, past_2_25_right=past, rescued=rescued,
        undecided=undecided, map_rounds_s=t_rounds, rescue_s=t_rescue)))
    g, pos = ref.idx.win_group, ref.idx.win_pos
    assert int(pos[g == 0].max()) >= 2**25 <= int(pos[g == 1].max())
    assert all(n in right for n, q in mapq.items() if q == 60), mapq
    assert len(right) >= 10 and past[0] and past[1], (right, hits)
