"""The port's copies of the JAX package's host modules against their
originals: sigmap_tpu_torch keeps its own config, utils, io, index, native
core, chaining, CWT, synth and CLI parser, so that it imports nothing of
sigmap_tpu.  One case per copied module, on seeded inputs at a tiny size
(a 50 kb genome); every comparison is exact, and files written by one
package are read by the other (the formats are shared).
"""

import dataclasses
import io
import os

import numpy as np
import pytest

import sigmap_tpu.cli as j_cli
import sigmap_tpu.config as j_config
import sigmap_tpu.evaluate as j_evaluate
import sigmap_tpu.index.build as j_build
import sigmap_tpu.index.sweep as j_sweep
import sigmap_tpu.io.fast5 as j_fast5
import sigmap_tpu.io.fasta as j_fasta
import sigmap_tpu.io.paf as j_paf
import sigmap_tpu.io.pore_model as j_pore
import sigmap_tpu.io.signals as j_signals
import sigmap_tpu.io.slow5 as j_slow5
import sigmap_tpu.mapping.chain as j_chain
import sigmap_tpu.native as j_native
import sigmap_tpu.ops.cwt as j_cwt
import sigmap_tpu.ops.fastdtw as j_fastdtw
import sigmap_tpu.parallel.multihost as j_multihost
import sigmap_tpu.synth as j_synth
import sigmap_tpu.utils as j_utils
import sigmap_tpu_torch.builders as p_builders
import sigmap_tpu_torch.cli as p_cli
import sigmap_tpu_torch.config as p_config
import sigmap_tpu_torch.evaluate as p_evaluate
import sigmap_tpu_torch.index.build as p_build
import sigmap_tpu_torch.index.sweep as p_sweep
import sigmap_tpu_torch.io.fast5 as p_fast5
import sigmap_tpu_torch.io.fasta as p_fasta
import sigmap_tpu_torch.io.paf as p_paf
import sigmap_tpu_torch.io.pore_model as p_pore
import sigmap_tpu_torch.io.signals as p_signals
import sigmap_tpu_torch.io.slow5 as p_slow5
import sigmap_tpu_torch.mapping.chain as p_chain
import sigmap_tpu_torch.native as p_native
import sigmap_tpu_torch.ops.cwt as p_cwt
import sigmap_tpu_torch.ops.fastdtw as p_fastdtw
import sigmap_tpu_torch.parallel.multihost as p_multihost
import sigmap_tpu_torch.synth as p_synth
import sigmap_tpu_torch.utils as p_utils
from _torch_util import jax_native_from_source  # noqa: F401 - fixture

GENOME_BASES = 50_000


@pytest.fixture(scope="module")
def data():
    pore = j_pore.make_synthetic_pore_model(k=6, seed=0)
    genome = j_synth.random_genome(GENOME_BASES, seed=4, n_seqs=2)
    reads = j_synth.simulate_reads(pore, genome, 6, seed=5, read_bases=800)
    return pore, genome, reads


def _port_pore(pore):
    """The JAX package's pore model as the port's dataclass."""
    return p_pore.PoreModel(**{f.name: getattr(pore, f.name)
                               for f in dataclasses.fields(pore)})


def _read_dicts(reads):
    return [dict(read_id=r.read_id, raw=r.raw, digitisation=r.digitisation,
                 range=r.range, offset=r.offset) for r in reads]


def _same_signals(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.read_id, x.digitisation, x.range, x.offset) == (
            y.read_id, y.digitisation, y.range, y.offset)
        np.testing.assert_array_equal(x.pa, y.pa)


def _same_arrays(a, b, names):
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, n
            np.testing.assert_array_equal(x, y, err_msg=n)
        else:
            assert x == y, n


INDEX_FIELDS = ("dim", "max_leaf", "bucket_dims", "cell_width", "values",
                "positions", "perm", "cell_keys", "cell_starts", "ref_names",
                "ref_lengths", "win_group", "win_pos")
SWEEP_FIELDS = ("tiles", "meta", "cum", "rot", "mu", "origin", "radixes",
                "span", "n_windows", "tile", "dim", "cell_width", "radius",
                "perm", "meta_flat")


def case_config(data, tmp):
    for J, P in ((j_config.SigmapConfig(), p_config.SigmapConfig()),
                 (j_config.EventDetectorConfig.rna(),
                  p_config.EventDetectorConfig.rna())):
        assert dataclasses.asdict(J) == dataclasses.asdict(P)


def case_utils(data, tmp):
    rng = np.random.default_rng(0)
    seq = bytes(rng.choice(list(b"ACGTNacgt"), 500))
    jc, pc = j_utils.encode_bases(seq), p_utils.encode_bases(seq)
    np.testing.assert_array_equal(jc, pc)
    np.testing.assert_array_equal(j_utils.revcomp_codes(jc),
                                  p_utils.revcomp_codes(pc))
    np.testing.assert_array_equal(j_utils.rolling_kmer_codes(jc, 6),
                                  p_utils.rolling_kmer_codes(pc, 6))
    assert [j_utils.seed_from_codes(jc, i, 6) for i in range(0, 500, 7)] == \
        [p_utils.seed_from_codes(pc, i, 6) for i in range(0, 500, 7)]
    xs = rng.normal(0, 100, 20).tolist() + [0.0, -0.0, 1e-7]
    assert [j_utils.fmt_float(x) for x in xs] == \
        [p_utils.fmt_float(x) for x in xs]
    np.testing.assert_array_equal(j_utils.CODE_TO_CHAR, p_utils.CODE_TO_CHAR)


ARGVS = [
    ["-i", "-r", "ref.fa", "-p", "pore.model", "-o", "idx"],
    ["-m", "-r", "r.fa", "-p", "p", "-x", "idx", "-s", "sig", "-o", "o.paf",
     "--read-batch", "2048", "-t", "4", "--search-radius", "0.1"],
    ["-m", "--engine", "exact", "--batch-mode", "--rna", "-d", "5",
     "--stop-mapping", "1.5", "--max-num-chunks", "10"],
    ["--debug-mode", "cwt-align", "-s", "sig"],
]


def case_cli(data, tmp):
    jp, pp = j_cli.build_parser(), p_cli.build_parser()

    def flags(parser):
        return [(a.option_strings, a.dest, a.default, a.help, a.choices,
                 a.type, a.nargs) for a in parser._actions]

    assert flags(jp) == flags(pp)
    for argv in ARGVS:
        ja, pa = jp.parse_args(argv), pp.parse_args(argv)
        assert vars(ja) == vars(pa)
        assert dataclasses.asdict(j_cli.make_config(ja)) == \
            dataclasses.asdict(p_cli.make_config(pa))


def _indexes(data):
    pore, genome, _ = data
    cfg = j_config.SigmapConfig()
    ji = j_build.build_index(
        [j_fasta.ReferenceSequence(n, c) for n, c in genome], pore,
        cfg.index, cfg.mapping.search_radius, verbose=False)
    pi = p_build.build_index(
        [p_fasta.ReferenceSequence(n, c) for n, c in genome],
        _port_pore(pore), p_config.SigmapConfig().index,
        cfg.mapping.search_radius, verbose=False)
    for i in (ji, pi):
        if i.win_group is None:
            i.derive_window_metadata()
    return ji, pi


def case_index_build(data, tmp):
    ji, pi = _indexes(data)
    _same_arrays(ji, pi, INDEX_FIELDS)
    # the port's torch builder (on the CPU) against the JAX package's
    pore, genome, _ = data
    ti = p_builders.build_index(
        [p_fasta.ReferenceSequence(n, c) for n, c in genome],
        _port_pore(pore), p_config.SigmapConfig().index,
        j_config.SigmapConfig().mapping.search_radius, "cpu")
    _same_arrays(ji, ti, INDEX_FIELDS)
    np.testing.assert_array_equal(j_build.zscore_f64(ji.values[:100]),
                                  p_build.zscore_f64(pi.values[:100]))
    ji.save(str(tmp / "j"))
    pi.save(str(tmp / "p"))
    assert (tmp / "j.sidx.npz").read_bytes() == \
        (tmp / "p.sidx.npz").read_bytes()
    _same_arrays(ji, p_build.SignalIndex.load(str(tmp / "j")), INDEX_FIELDS)
    _same_arrays(pi, j_build.SignalIndex.load(str(tmp / "p")), INDEX_FIELDS)


def case_index_sweep(data, tmp):
    ji, pi = _indexes(data)
    js = j_sweep.SweepIndex.build(ji, 0.08, tile=256)
    ps = p_sweep.SweepIndex.build(pi, 0.08, tile=256)
    _same_arrays(js, ps, SWEEP_FIELDS)
    # the port's torch store builder (on the CPU) against the JAX package's
    ts = p_builders.materialize(*p_builders.sweep_store(pi, 0.08, tile=256,
                                                        device="cpu"))
    _same_arrays(js, ts, SWEEP_FIELDS)
    js.save(str(tmp / "j.npz"))
    ps.save(str(tmp / "p.npz"))
    _same_arrays(js, p_sweep.SweepIndex.load(str(tmp / "j.npz")),
                 SWEEP_FIELDS)
    _same_arrays(ps, j_sweep.SweepIndex.load(str(tmp / "p.npz")),
                 SWEEP_FIELDS)


def case_io_fasta(data, tmp):
    _, genome, _ = data
    recs = [(n, j_utils.CODE_TO_CHAR[c].tobytes().decode())
            for n, c in genome]
    j_fasta.write_fasta(str(tmp / "j.fa"), recs, width=60)
    p_fasta.write_fasta(str(tmp / "p.fa"), recs, width=60)
    assert (tmp / "j.fa").read_bytes() == (tmp / "p.fa").read_bytes()
    for a, b in zip(j_fasta.read_fasta(str(tmp / "p.fa")),
                    p_fasta.read_fasta(str(tmp / "j.fa"))):
        assert (a.name, a.length) == (b.name, b.length)
        np.testing.assert_array_equal(a.codes, b.codes)


def _paf_text(paf, tmp, name):
    summ = paf.ChainsSummary(num_anchors=12, num_chains=3, s1=41.25,
                             s2=12.5, sm=7.0, ad=0.031, at=1.5, aq=2.25)
    recs = [
        paf.PAFRecord(0, "read_0", 800, 10, 790, 1, 1200, 2400, 60, 1,
                      paf.streaming_tags(1.5, 3, 8000, summ)),
        paf.PAFRecord(1, "read_1", 900, 0, 0, 0, 0, 0, 61, 0,
                      paf.streaming_tags(2.0, 30, 27000, None)),
        paf.PAFRecord(2, "read_2", 700, 5, 600, 0, 33, 980, 17, 0,
                      paf.batch_tags(0.5, 6000, summ)),
        paf.PAFRecord(3, "read_3", 500, 0, 0, 0, 0, 0, 61, 1,
                      paf.batch_tags(0.25, 4000, None)),
    ]
    w = paf.PAFWriter(str(tmp / name), ["chr_a", "chr_b"], [25_000, 25_000])
    for r in recs:
        w.append(r)
    assert w.finalize() == 4
    return (tmp / name).read_text()


def case_io_paf(data, tmp):
    assert _paf_text(j_paf, tmp, "j.paf") == _paf_text(p_paf, tmp, "p.paf")


def case_io_pore_model(data, tmp):
    for k, seed in ((6, 0), (5, 3)):
        jp = j_pore.make_synthetic_pore_model(k=k, seed=seed)
        pp = p_pore.make_synthetic_pore_model(k=k, seed=seed)
        jp.save(str(tmp / "j.model"))
        pp.save(str(tmp / "p.model"))
        assert (tmp / "j.model").read_bytes() == \
            (tmp / "p.model").read_bytes()
        _same_arrays(j_pore.PoreModel.load(str(tmp / "p.model")),
                     p_pore.PoreModel.load(str(tmp / "j.model")),
                     [f.name for f in dataclasses.fields(jp)])
    codes = data[1][0][1][:300]
    np.testing.assert_array_equal(jp.expected_signal(codes),
                                  pp.expected_signal(codes))


def case_io_signals(data, tmp):
    reads = data[2]
    sig = tmp / "sig"
    sig.mkdir()
    j_slow5.write_blow5(str(sig / "a.blow5"), _read_dicts(reads[:3]))
    j_slow5.write_slow5(str(sig / "b.slow5"), _read_dicts(reads[3:]))
    j_fast5.write_multi_fast5(str(sig / "c.fast5"), _read_dicts(reads[:2]))
    for lo, hi in ((30.0, 200.0), (0.0, 1000.0)):
        _same_signals(j_signals.load_all_read_signals(str(sig), lo, hi),
                      p_signals.load_all_read_signals(str(sig), lo, hi))
    r = reads[0]
    np.testing.assert_array_equal(
        j_signals.dac_to_pa(r.raw, r.digitisation, r.range, r.offset),
        p_signals.dac_to_pa(r.raw, r.digitisation, r.range, r.offset))


def case_io_slow5(data, tmp):
    rd = _read_dicts(data[2])
    for rec_comp, sig_comp in ((p_slow5.COMP_ZLIB, p_slow5.SIGCOMP_NONE),
                               (p_slow5.COMP_ZLIB, p_slow5.SIGCOMP_SVB_ZD),
                               (p_slow5.COMP_NONE, p_slow5.SIGCOMP_SVB_ZD)):
        j_slow5.write_blow5(str(tmp / "j.blow5"), rd, rec_comp, sig_comp)
        p_slow5.write_blow5(str(tmp / "p.blow5"), rd, rec_comp, sig_comp)
        assert (tmp / "j.blow5").read_bytes() == \
            (tmp / "p.blow5").read_bytes()
        _same_signals(j_slow5.read_blow5(str(tmp / "p.blow5")),
                      p_slow5.read_blow5(str(tmp / "j.blow5")))
    j_slow5.write_slow5(str(tmp / "j.slow5"), rd)
    p_slow5.write_slow5(str(tmp / "p.slow5"), rd)
    assert (tmp / "j.slow5").read_bytes() == (tmp / "p.slow5").read_bytes()


def case_io_fast5(data, tmp):
    rd = _read_dicts(data[2])
    j_fast5.write_multi_fast5(str(tmp / "j.fast5"), rd)
    p_fast5.write_multi_fast5(str(tmp / "p.fast5"), rd)
    _same_signals(j_fast5.read_fast5(str(tmp / "p.fast5")),
                  p_fast5.read_fast5(str(tmp / "j.fast5")))
    _same_signals(j_fast5.read_fast5(str(tmp / "j.fast5")),
                  p_fast5.read_fast5(str(tmp / "p.fast5")))


def case_synth(data, tmp):
    pore = data[0]
    jg = j_synth.random_genome(GENOME_BASES, seed=9, n_seqs=2)
    pg = p_synth.random_genome(GENOME_BASES, seed=9, n_seqs=2)
    assert j_synth.genome_to_fasta_str(jg) == p_synth.genome_to_fasta_str(pg)
    jr = j_synth.simulate_reads(pore, jg, 5, seed=2, read_bases=600)
    pr = p_synth.simulate_reads(_port_pore(pore), pg, 5, seed=2,
                                read_bases=600)
    for a, b in zip(jr, pr):
        _same_arrays(a, b, [f.name for f in dataclasses.fields(a)])


def _chains(chain, cfg, rng_seed):
    rng = np.random.default_rng(rng_seed)
    new = {}
    for key in ((0, 0), (0, 1), (1, 0)):
        n = 400
        t = np.sort(rng.integers(0, 20_000, n))
        q = np.sort(rng.integers(0, 3_000, n))
        # a true diagonal inside the noise
        t[::4] = 5_000 + q[::4] * (key[1] + 1)
        new[key] = chain.make_anchors(
            t, q, rng.random(n).astype(np.float32) * np.float32(0.08))
    return chain.generate_chains(new, [], 2, 0.08, 6, cfg)


def case_mapping_chain(data, tmp):
    got = _chains(p_chain, p_config.ChainingConfig(), 3)
    want = _chains(j_chain, j_config.ChainingConfig(), 3)
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.sort_key() == b.sort_key() and a.mapq == b.mapq
        np.testing.assert_array_equal(a.anchors, b.anchors)


def case_ops_cwt(data, tmp):
    r = data[2][1]
    pa = j_signals.dac_to_pa(r.raw, r.digitisation, r.range, r.offset)
    for scale in (3.0, 6.5):
        for a, b in zip(j_cwt.cwt_feature_signal(pa, scale),
                        p_cwt.cwt_feature_signal(pa, scale)):
            np.testing.assert_array_equal(a, b)


def _native_inputs():
    rng = np.random.default_rng(1)
    vals = rng.normal(0, 1, 20_000).astype(np.float32)
    qs = rng.normal(0, 1, (64, 6)).astype(np.float32)
    return vals, qs


def case_native(data, tmp):
    """Source against source: the jax_native_from_source fixture (requested
    by the test below) has pointed sigmap_tpu.native at its own build of
    native/core.cc with the port's flags."""
    assert j_native.available() and p_native.available()
    vals, qs = _native_inputs()
    jt, pt = j_native.KdTree(vals, 6), p_native.KdTree(vals, 6)
    for a, b in zip(jt.radius_batch(qs, 0.8), pt.radius_batch(qs, 0.8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jt.radius(qs[0], 1.5), pt.radius(qs[0], 1.5)):
        np.testing.assert_array_equal(a, b)
    ji, jl = j_native.dedup(vals, None, 0.1)
    pi, pl = p_native.dedup(vals, None, 0.1)
    np.testing.assert_array_equal(ji, pi)
    assert jl == pl
    for a, b in zip(j_native.features(vals * 10 + 90),
                    p_native.features(vals * 10 + 90)):
        np.testing.assert_array_equal(a, b)


def _evaluate_records(reads):
    """PAF records of the simulated reads: mapped on the true locus and
    strand, mapped on the wrong strand, mapped elsewhere, unmapped, without
    tags, and one read with no record at all."""
    recs = []
    for i, r in enumerate(reads[:-1]):
        kind = i % 5
        lo = r.ref_start if kind != 2 else r.ref_end + 10_000
        mapped = kind in (0, 1, 2)
        tags = (f"mt:f:{1.5 * i + 0.25:.6f}\tci:i:{i % 3 + 1}\tsl:i:1000"
                if kind != 4 else "")
        recs.append(j_paf.PAFRecord(
            read_id=i, read_name=r.read_id, read_length=1000,
            read_start=0, read_end=500 if mapped else 0, ref_index=0,
            fragment_start=lo if mapped else 0,
            fragment_length=(r.ref_end - r.ref_start) if mapped else 0,
            mapq=60 if mapped else 61,
            direction=(r.strand if kind != 1 else 1 - r.strand)
            if mapped else 0, tags=tags))
    return recs


def case_evaluate(data, tmp):
    """The same records against the same truth, and the same annotated PAF
    file: equal counts, times and printed report."""
    _, _, reads = data
    recs = _evaluate_records(reads)
    outs = []
    for ev in (j_evaluate, p_evaluate):
        out = io.StringIO()
        res = ev.evaluate_against_truth(recs, reads, out=out)
        outs.append((dataclasses.astuple(res), res.precision, res.recall,
                     res.f1, out.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0][:3] != (0, 0, 0)
    paf = tmp / "annotated.paf"
    paf.write_text(
        "r1\t100\t0\t50\t+\tc\t1000\t10\t60\t100\t51\t60\t"
        "mt:f:5.0\tci:i:2\tsl:i:100\tkl:Z:tp\n"
        "r2\t100\t*\t*\t*\t*\t*\t*\t*\t*\t*\t61\tmt:f:1.0\tci:i:1"
        "\tkl:Z:fn\n"
        "r3\t90\t0\t40\t-\tc\t1000\t20\t70\t50\t51\t20\tmt:f:7.25"
        "\tci:i:3\tkl:Z:fp\n"
        "r4\t80\t*\t*\t*\t*\t*\t*\t*\t*\t*\t61\tmt:f:0.5\tkl:Z:tn\n"
        "r5\t70\t*\t*\t*\t*\t*\t*\t*\t*\t*\t61\tmt:f:9.0\tkl:Z:na\n"
        "short\tline\n")
    outs = []
    for ev in (j_evaluate, p_evaluate):
        out = io.StringIO()
        res = ev.evaluate_annotated_paf(str(paf), out=out)
        outs.append((dataclasses.astuple(res), out.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0][:4] == (1, 1, 1, 1)


def _dtw_pair(seed, tlen=400, sub=50, rep=3):
    """tests/test_ops.py:_pair: a target and a stretched, noisy piece."""
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 1, tlen).astype(np.float32)
    q = np.repeat(t[100: 100 + sub], rep) + rng.normal(
        0, 0.02, sub * rep).astype(np.float32)
    return t, q


def _same_dtw(a, b):
    """Equal (distance, path, end[, cigar]) tuples, exactly."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def case_ops_fastdtw(data, tmp):
    """tests/test_ops.py's fastdtw inputs (its _pair at seeds 0 and 2, the
    radii 30 and 2, test_cigar_flags' path) through both packages: the full
    DTW, fastdtw, the reduction, the window dilation and the per-base
    CIGAR, exactly."""
    for seed in (0, 2):
        t, q = _dtw_pair(seed)
        _same_dtw(j_fastdtw.dtw_windowed(t, q, None),
                  p_fastdtw.dtw_windowed(t, q, None))
        for radius in (30, 2):
            _same_dtw(j_fastdtw.fastdtw(t, q, radius=radius),
                      p_fastdtw.fastdtw(t, q, radius=radius))
        np.testing.assert_array_equal(j_fastdtw.reduce_by_half(q),
                                      p_fastdtw.reduce_by_half(q))
        _, path, _ = j_fastdtw.dtw_windowed(j_fastdtw.reduce_by_half(t),
                                            j_fastdtw.reduce_by_half(q), None)
        for a, b in zip(j_fastdtw.expand_window(path, len(t), len(q), 2),
                        p_fastdtw.expand_window(path, len(t), len(q), 2)):
            np.testing.assert_array_equal(a, b)
        assert j_fastdtw.print_alignment(path) == \
            p_fastdtw.print_alignment(path)
    path = [(0, 0, 0), (1, 1, 0), (1, 2, 1), (1, 3, 2), (2, 4, 0), (3, 4, 3)]
    assert p_fastdtw.print_alignment(path) == \
        j_fastdtw.print_alignment(path) == "(1M)(2M1I)(1M)"


def case_parallel_multihost(data, tmp):
    """shard_files_for_host over unsorted names at 1-3 processes, and
    merge_host_paf of three partials given out of rank order (one empty):
    the same shares, the same merged file and line count."""
    names = [f"d{i % 2}/r{i}.blow5" for i in (5, 0, 3, 6, 1, 4, 2)]
    for n in (1, 2, 3):
        for pid in range(n):
            assert p_multihost.shard_files_for_host(names, pid, n) == \
                j_multihost.shard_files_for_host(names, pid, n)
    parts = []
    for rank, lines in ((2, ["c\t1\n"]), (0, ["a\t1\n", "a\t2\n"]),
                        (1, [])):
        parts.append(str(tmp / f"part_{rank:03d}.paf"))
        with open(parts[-1], "w") as f:
            f.writelines(lines)
    out = []
    for pkg in (j_multihost, p_multihost):
        path = tmp / f"merged_{pkg.__name__.split('.')[0]}.paf"
        out.append((pkg.merge_host_paf(parts, str(path)), path.read_text()))
    assert out[0] == out[1] == (3, "a\t1\na\t2\nc\t1\n")


CASES = {
    "config": case_config, "utils": case_utils, "cli": case_cli,
    "index.build": case_index_build, "index.sweep": case_index_sweep,
    "io.fasta": case_io_fasta, "io.paf": case_io_paf,
    "io.pore_model": case_io_pore_model, "io.signals": case_io_signals,
    "io.slow5": case_io_slow5, "io.fast5": case_io_fast5,
    "synth": case_synth, "mapping.chain": case_mapping_chain,
    "ops.cwt": case_ops_cwt, "native": case_native,
    "evaluate": case_evaluate, "ops.fastdtw": case_ops_fastdtw,
    "parallel.multihost": case_parallel_multihost,
}


@pytest.mark.parametrize("module", sorted(CASES))
def test_port_copy_matches_original(module, data, tmp_path,
                                    jax_native_from_source):
    """sigmap_tpu_torch.<module> gives what sigmap_tpu.<module> gives."""
    CASES[module](data, tmp_path)


def test_native_core_has_no_contracted_multiply_add():
    """The port's host core rounds op by op on every host: its k-d tree's
    squared distances equal a numpy f32 evaluation of sum((w - q)**2) taken
    in dimension order, exactly, where a contracted multiply-add (FMA)
    would differ in the last bit of some of them."""
    assert p_native.available()
    vals, qs = _native_inputs()
    dim = qs.shape[1]
    win = np.lib.stride_tricks.sliding_window_view(vals, dim)
    idx, d2, cnt = p_native.KdTree(vals, dim).radius_batch(qs, 0.8)
    assert len(idx) > 1000
    q = np.repeat(qs, cnt, axis=0)
    diff = win[idx] - q                       # f32 - f32, rounded once
    want = np.zeros(len(idx), np.float32)
    for k in range(dim):                      # one rounding a mul, one an add
        want = want + diff[:, k] * diff[:, k]
    assert want.dtype == np.float32
    np.testing.assert_array_equal(d2, want)


def test_every_copy_has_a_case():
    """Each module the port copied from the JAX package has a case above."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sigmap_tpu_torch")
    copies = {"config", "utils", "synth", "native", "mapping.chain",
              "ops.cwt", "cli", "evaluate", "ops.fastdtw",
              "parallel.multihost"}
    for sub in ("io", "index"):
        copies |= {f"{sub}.{f[:-3]}" for f in os.listdir(os.path.join(
            root, sub)) if f.endswith(".py") and f != "__init__.py"}
    assert copies == set(CASES)
