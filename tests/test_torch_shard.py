"""The port's multi-device turbo mapper (sigmap_tpu_torch.parallel) on the
CPU, against the port's and the JAX package's single-device mappers and the
JAX TurboShardMapper, on tests/test_turbo_shard.py's workload: an 80 kb
genome (seed 21), 8 reads of 2200 bases (seed 6), read batch 8,
TurboParams(S=256, K=32, RING=64, TILE=256).

Each mesh runs as gloo processes, one a rank (tests/_torch_shard_worker.py),
each with a wall limit and a process-group timeout; the parent writes the
index and the reads once and the workers load them.  Records equal the
port's single-device ones apart from mt: exactly; the JAX package's within
the float-tag tolerance of tests/test_torch_turbo.py (XLA's CPU backend
fuses multiply-adds; every other field and tag exact).  The merge is held
to jax.lax.top_k and the tile split to the JAX ShardedSweep exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu.synth import random_genome, simulate_reads
from sigmap_tpu_torch.index.build import SignalIndex as PortIndex
from sigmap_tpu_torch.io.paf import PAFRecord
from sigmap_tpu_torch.io.signals import load_all_read_signals
from sigmap_tpu_torch.io.slow5 import COMP_ZLIB, SIGCOMP_NONE, write_blow5
from sigmap_tpu_torch.mapping.turbo import TurboMapper, TurboParams
from sigmap_tpu_torch.parallel import multihost
from sigmap_tpu_torch.parallel import turbo_shard as port

from _torch_shard_worker import paf_line
from chip_smoke import run_shard_ranks, threaded_shard_map

PARAMS = dict(S=256, K=32, RING=64, TILE=256)
READ_BATCH = 8
WALL_S = 240          # a worker's wall limit
PG_TIMEOUT_S = 120    # its process group's timeout
# tests/test_torch_turbo.py's bounds on the float tags against the JAX
# package
RTOL = 1e-5
AD_RTOL = 3e-4


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """tests/test_turbo_shard.py:workload, with the index written once
    (SignalIndex.save) and the reads as BLOW5 for the workers."""
    tmp = tmp_path_factory.mktemp("shard")
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(80_000, seed=21)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    reads = simulate_reads(pore, genome, 8, seed=6, read_bases=2200)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=READ_BATCH))
    prefix = str(tmp / "idx")
    idx.save(prefix)
    sig = tmp / "signals"
    sig.mkdir()
    write_blow5(str(sig / "reads.blow5"),
                [dict(read_id=r.read_id, raw=r.raw,
                      digitisation=r.digitisation, range=r.range,
                      offset=r.offset) for r in reads],
                rec_comp=COMP_ZLIB, sig_comp=SIGCOMP_NONE)
    port_signals = load_all_read_signals(str(sig))
    for a, b in zip(signals, port_signals):
        np.testing.assert_array_equal(a.pa, b.pa)
    return dict(cfg=cfg, idx=idx, reads=reads, signals=signals,
                prefix=prefix, sig=str(sig), tmp=tmp,
                port_idx=PortIndex.load(prefix), port_signals=port_signals)


def _port_cfg(cfg):
    from sigmap_tpu_torch.config import SigmapConfig as PortConfig

    return PortConfig(runtime=dataclasses.replace(
        PortConfig().runtime, read_batch=cfg.runtime.read_batch))


@pytest.fixture(scope="module")
def port_single(work):
    """The port's single-device records of the workload."""
    mapper = TurboMapper(work["port_idx"], _port_cfg(work["cfg"]),
                         TurboParams(**PARAMS), device="cpu")
    try:
        return mapper.streaming_map(work["port_signals"])
    finally:
        mapper.close()


@pytest.fixture(scope="module")
def jax_single(work):
    from sigmap_tpu.mapping.turbo import TurboMapper as JaxTurboMapper
    from sigmap_tpu.mapping.turbo import TurboParams as JaxTurboParams

    p = JaxTurboParams(peaks_impl="scan", **PARAMS)
    return JaxTurboMapper(work["idx"], work["cfg"], p).streaming_map(
        work["signals"])


def run_ranks(work, D, I, name, paf=False, params=PARAMS):
    """One gloo process a rank of a D x I mesh on the CPU, each with its
    wall limit (chip_smoke.run_shard_ranks); returns what each rank wrote.
    Fails if a rank fails or outlives its limit."""
    out = str(work["tmp"] / name)
    args = ["--backend", "gloo", "--device", "cpu", "--timeout",
            str(PG_TIMEOUT_S), "--index", work["prefix"], "--signals",
            work["sig"], "--read-batch", str(READ_BATCH), "--params",
            json.dumps(params)] + (["--paf-dir", out] if paf else [])
    return run_shard_ranks((D, I), out, args, wall_s=WALL_S)[0]


def _without_mt(records):
    """Records as dicts, the mt: tag left out."""
    out = []
    for r in records:
        r = r if isinstance(r, dict) else dataclasses.asdict(r)
        out.append(dict(r, tags=[t for t in r["tags"].split("\t")
                                 if not t.startswith("mt:")]))
    return out


def _same_as_jax(got, want):
    """Port records against the JAX package's: every field and integer tag
    exact, float tags within RTOL (ad: AD_RTOL), as
    tests/test_torch_turbo.py:test_port_streaming_map_matches_jax."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        gt = dict(t.split(":", 1) for t in g.pop("tags").split("\t"))
        wt = dict(t.split(":", 1) for t in w.pop("tags").split("\t"))
        assert g == w
        assert gt.keys() == wt.keys()
        for k in gt.keys() - {"mt"}:
            kind, gv = gt[k].split(":")
            wv = wt[k].split(":")[1]
            if kind == "f":
                tol = (AD_RTOL if k == "ad" else RTOL) * abs(float(wv))
                assert abs(float(gv) - float(wv)) <= tol + 2e-6, (k, gv, wv)
            else:
                assert gv == wv, (g["read_name"], k, gv, wv)


@pytest.fixture(scope="module")
def shard_runs(work):
    """Each mesh's per-rank outputs, run once for the module."""
    runs = {}

    def get(D, I):
        if (D, I) not in runs:
            runs[D, I] = run_ranks(work, D, I, f"mesh_{D}x{I}")
        return runs[D, I]

    return get


@pytest.mark.parametrize("mesh", [(4, 2), (2, 4), (8, 1)])
def test_shard_records_equal_single(work, port_single, jax_single,
                                    shard_runs, mesh):
    """Every rank returns every read's record in input order; they equal
    the port's single-device records apart from mt: and the JAX package's
    TurboMapper's within the float-tag tolerance.  No seed of this
    workload overflows K, so no record is exempt."""
    outs = shard_runs(*mesh)
    assert [(o["d"], o["i"]) for o in outs] == [
        divmod(r, mesh[1]) for r in range(len(outs))]
    recs = [[PAFRecord(**r) for r in o["records"]] for o in outs]
    assert all(r == recs[0] for r in recs)
    assert [r.read_id for r in recs[0]] == list(range(len(work["signals"])))
    assert all(o["overflow"] == [] for o in outs)
    assert _without_mt(recs[0]) == _without_mt(port_single)
    _same_as_jax(recs[0], jax_single)
    assert sum(r.is_mapped for r in recs[0]) >= 7


def test_overflow_reads_rescued_once(work):
    """With S=16, K=1 every read overflows (seeds past S, matches past K)
    and the unmapped ones are rescued.  At mesh (2, 2) each is rescued
    once, by index rank 0 of its data group (the other ranks rescue none),
    the overflow and rescued reads are the single-device mapper's, and the
    records equal its records apart from mt:, and the one-process
    emulation of two index shards (chip_smoke.threaded_shard_map, which
    chip_smoke.py holds the card's runs to) gives the same."""
    params = dict(PARAMS, S=16, K=1)
    mapper = TurboMapper(work["port_idx"], _port_cfg(work["cfg"]),
                         TurboParams(**params), device="cpu")
    try:
        want = mapper.streaming_map(work["port_signals"])
    finally:
        mapper.close()
    single = mapper.last_pass
    assert single["overflow"] == list(range(8))
    assert single["rescued"]
    outs = run_ranks(work, 2, 2, "overflow", params=params)
    for o in outs:
        assert o["overflow"] == single["overflow"]
        assert o["rescued"] == sorted(single["rescued"])
        assert o["n_rescued_here"] == 0 or o["i"] == 0
    assert sum(o["n_rescued_here"] for o in outs) == len(single["rescued"])
    got = [PAFRecord(**r) for r in outs[0]["records"]]
    assert _without_mt(got) == _without_mt(want)
    emu, emu_pass = threaded_shard_map(
        work["port_idx"], _port_cfg(work["cfg"]), TurboParams(**params), 2,
        work["port_signals"], "cpu")
    assert _without_mt(emu) == _without_mt(got)
    assert (emu_pass["overflow"], sorted(emu_pass["rescued"])) == (
        outs[0]["overflow"], outs[0]["rescued"])


def test_shard_records_equal_jax_shard_mapper(work, shard_runs):
    """At mesh (4, 2) the port's records equal the JAX TurboShardMapper's
    on conftest's virtual 8-device CPU mesh (float tags within the
    tolerance)."""
    from jax.sharding import Mesh

    from sigmap_tpu.mapping.turbo import TurboParams as JaxTurboParams
    from sigmap_tpu.parallel.turbo_shard import TurboShardMapper

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "index"))
    want = TurboShardMapper(
        work["idx"], work["cfg"], mesh,
        JaxTurboParams(peaks_impl="scan", **PARAMS)).streaming_map(
        work["signals"])
    got = [PAFRecord(**r) for r in shard_runs(4, 2)[0]["records"]]
    _same_as_jax(got, want)


def test_two_process_merged_paf(work, port_single):
    """tests/test_multihost.py's counterpart: two gloo processes (mesh (2,
    1): the reads split between them), each writes its contiguous part of
    the records, rank 0 merges the parts with merge_host_paf; the merged
    file equals the single-device lines, and 7 of the 8 reads map."""
    outs = run_ranks(work, 2, 1, "two_process", paf=True)
    assert len(outs) == 2
    lines = (work["tmp"] / "two_process" / "merged.paf").read_text(
        ).splitlines()
    idx = work["port_idx"]
    want = [paf_line(r, idx) for r in port_single]
    assert lines == want
    assert sum("\t+\t" in x or "\t-\t" in x for x in lines) >= 7


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_sweep_equals_jax(work, n_shards):
    """ShardedSweep.build == the JAX package's, exactly, at the workload's
    tile width, where 2 and 4 shards do not divide the tile count (so the
    last shard is padded)."""
    from sigmap_tpu.parallel.turbo_shard import ShardedSweep as JaxSharded

    radius, tile = work["cfg"].mapping.search_radius, PARAMS["TILE"]
    got = port.ShardedSweep.build(work["port_idx"], radius, n_shards,
                                  tile=tile)
    want = JaxSharded.build(work["idx"], radius, n_shards, tile=tile)
    for name in ("tiles", "meta", "cum", "rot", "mu", "origin"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.geom, got.n_windows, got.tile) == (
        want.geom, want.n_windows, want.tile)
    T = -(-got.n_windows // tile)
    assert T % 2 == 1
    assert got.tiles.shape[:2] == (n_shards, -(-T // n_shards))


def _jax_merge(am, ad, aw, cnt, K):
    """turbo_shard.py:105-115 (make_sharded_round's merge_matches) on the
    gathered arrays, the collectives left out: the psum is a sum over the
    shard axis."""
    I, Q, _ = am.shape
    am, ad, aw = jnp.asarray(am), jnp.asarray(ad), jnp.asarray(aw)
    valid = jnp.arange(K)[None, None, :] < aw[:, :, None]
    d = jnp.where(valid, ad, port.INF)
    d = d.transpose(1, 0, 2).reshape(Q, I * K)
    mm = am.transpose(1, 0, 2).reshape(Q, I * K)
    neg_d, ti = jax.lax.top_k(-d, K)
    m_d2m = -neg_d
    m_metam = jnp.take_along_axis(mm, ti, axis=1)
    wrote_m = (m_d2m < port.INF / 2).sum(axis=1).astype(jnp.int32)
    return (np.asarray(m_metam), np.asarray(m_d2m),
            np.asarray(jnp.asarray(cnt).sum(axis=0)), np.asarray(wrote_m))


@pytest.mark.parametrize("I,K", [(1, 4), (2, 8), (3, 4), (4, 1)])
def test_merge_equals_jax_top_k(I, K):
    """merge_shard_matches == jax.lax.top_k's merge, exactly: d^2 drawn
    from four values, so ties fall within a shard and across shards; every
    wrote from 0 to K (seeds where every shard wrote 0 among them); junk in
    the unfilled slots."""
    rng = np.random.default_rng(I * 10 + K)
    Q = 257
    aw = rng.integers(0, K + 1, (I, Q)).astype(np.int32)
    aw[:, :5] = 0
    ad = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75]), (I, Q, K))
    ad[np.arange(K)[None, None, :] >= aw[:, :, None]] = np.float32(-7.0)
    am = rng.integers(0, 1 << 30, (I, Q, K)).astype(np.int32)
    cnt = rng.integers(0, 3 * K, (I, Q)).astype(np.int32)
    want = _jax_merge(am, ad, aw, cnt, K)
    got = port.merge_shard_matches(
        torch.from_numpy(am), torch.from_numpy(ad), torch.from_numpy(aw),
        torch.from_numpy(cnt).sum(0, dtype=torch.int32), K)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (want[3][:5] == 0).all()
    assert (want[3] < K).any() and (want[3] == K).any()


def test_read_batch_must_divide_the_data_axis(work):
    """A read batch the data axis does not divide is refused (as
    turbo_shard.py:174), by the mapper and by local_read_rows."""
    mesh = port.ShardMesh(D=3, I=1, rank=0, d=0, i=0, index_group=None,
                          data_group=None, object_group=None,
                          device=torch.device("cpu"))
    with pytest.raises(ValueError, match="read_batch must divide"):
        port.TurboShardMapper(work["port_idx"], _port_cfg(work["cfg"]), mesh,
                              TurboParams(**PARAMS), device="cpu")
    with pytest.raises(ValueError, match="read_batch must divide"):
        multihost.local_read_rows(20, READ_BATCH, 0, 3)


def test_local_read_rows():
    """Data rank d maps rows [d * Bl, (d + 1) * Bl) of each global batch;
    the ranks' rows cover every read once, the last batch short."""
    rows = [multihost.local_read_rows(21, 8, d, 4) for d in range(4)]
    assert rows[0].tolist() == [0, 1, 8, 9, 16, 17]
    assert rows[2].tolist() == [4, 5, 12, 13, 20]
    assert rows[3].tolist() == [6, 7, 14, 15]
    assert sorted(np.concatenate(rows).tolist()) == list(range(21))


def test_initialize_distributed_needs_a_backend_and_an_address(monkeypatch):
    """The backend is the caller's (no automatic choice), and without an
    address or torchrun's environment nothing is started."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize_distributed("localhost:1", 1, 0, backend="mpi",
                                         timeout=5)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize_distributed(backend="gloo", timeout=5)
    assert not torch.distributed.is_initialized()
