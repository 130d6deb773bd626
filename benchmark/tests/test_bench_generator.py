"""The generator: genomes, pools and truths from the seed."""

import json
import os

import numpy as np

from benchmark import synthgen, workload

BIG_SEED = 2**31 + 12345


def tiny_cell(traffic_name="readuntil-512", contigs=(("a", 40_000),
                                                      ("b", 25_000))):
    """A cell of the ecoli-k12 configuration and the named traffic file,
    cut to tiny contigs and calls of 20 reads."""
    here = os.path.join(workload.ROOT, "benchmark")
    with open(os.path.join(here, "configs", "ecoli-k12.json")) as f:
        config = json.load(f)
    with open(os.path.join(here, "traffic", traffic_name + ".json")) as f:
        t = json.load(f)
    config["contigs"] = [list(c) for c in contigs]
    t.update(reads_per_call=20, read_batch=20, pool_calls=2,
             off_target_genome_bases=30_000)
    if t["read_bases"]["kind"] == "lognormal":
        t["read_bases"] = dict(t["read_bases"], clip=[1000, 3000])
    return workload.Cell("tiny", 1, config, t)


def test_contigs_have_the_configured_lengths_and_follow_the_seed():
    cell = tiny_cell()
    a = workload.make_inputs(cell, BIG_SEED)
    b = workload.make_inputs(cell, BIG_SEED)
    c = workload.make_inputs(cell, BIG_SEED + 1)
    assert [(n, len(x)) for n, x in a.genome] == [("a", 40_000),
                                                  ("b", 25_000)]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in
               zip(a.genome, b.genome))
    assert all(np.array_equal(x[1], y[1]) for h, g in zip(a.pools, b.pools)
               for x, y in zip(h, g))
    assert not np.array_equal(a.genome[0][1], c.genome[0][1])


def test_truths_and_off_target_share():
    cell = tiny_cell()
    inp = workload.make_inputs(cell, BIG_SEED)
    truths = list(inp.truths.values())
    assert len(truths) == 40
    assert [sum(not inp.truths[rid].on_target for rid, _ in h)
            for h in inp.pools] == [round(0.10 * 20)] * 2
    lens = dict(inp.genome)
    for t in truths:
        if t.on_target:
            name = inp.genome[t.ref_index][0]
            assert 0 <= t.ref_start < t.ref_end <= len(lens[name])
            assert t.read_id.startswith("read_")
        else:
            assert t.ref_index == -1 and t.read_id.startswith("off_")
    # every pA sample lies in the open (30, 200) window
    for part in inp.pools:
        for _, pa in part:
            assert pa.dtype == np.float32
            assert (pa > 30).all() and (pa < 200).all()


def test_every_seed_and_part_gets_one_set_of_lengths():
    cell = tiny_cell()
    sets = []
    for seed in (1, BIG_SEED):
        inp = workload.make_inputs(cell, seed)
        for h in inp.pools:
            t = [inp.truths[rid] for rid, _ in h]
            sets.append((sorted(x.ref_end - x.ref_start for x in t),
                         sorted(x.ref_end - x.ref_start for x in t
                                if not x.on_target)))
    assert all(s == sets[0] for s in sets)


def test_expected_levels_are_gathered_like_the_fragment_model():
    rng = np.random.default_rng(3)
    pore = synthgen.synthetic_pore()
    genome = synthgen.random_contigs([("a", 3000), ("b", 2000)], rng)
    km, off_f, off_r = synthgen._kmer_table(genome, pore.k)
    for strand in (0, 1):
        for ci, (_, codes) in enumerate(genome):
            for s, b in ((0, 100), (17, 900), (len(codes) - 120, 110)):
                frag = codes[s: s + b + pore.k - 1]
                if strand == 0:
                    frag = synthgen.revcomp(frag)
                want = synthgen.expected_signal(pore, frag)
                p0 = (off_f[ci] + s if strand == 1
                      else off_r[ci] + len(codes) - s - b - pore.k + 1)
                idx = synthgen.fragment_kmers(km, p0, b, pore.k)
                assert np.array_equal(pore.level_mean[idx], want)


def test_pool_parts_follow_the_traffic():
    cell = tiny_cell()
    cell.traffic = dict(cell.traffic, pool_calls=5)
    inp = workload.make_inputs(cell, BIG_SEED)
    assert [len(p) for p in inp.pools] == [20] * 5
    ids = [{rid for rid, _ in p} for p in inp.pools]
    assert all(not (a & b) for i, a in enumerate(ids) for b in ids[i + 1:])
