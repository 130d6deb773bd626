"""Port of the turbo engine vs sigmap_tpu.mapping.turbo on the 200 kb
workload of tests/test_turbo.py (B=32, S=256, K=16, RING=64, TILE=256).

* slice: TurboMapper(device="cpu").streaming_map gives the JAX mapper's
  PAF records field for field, except the mt: timing tag and the last
  printed digits of the float tags: XLA's CPU backend fuses
  multiply-adds in the d^2 and chaining arithmetic, the port rounds each
  f32 operation separately like the TPU and the CUDA kernels.  Scores agree
  within RTOL, and ad (mean d^2 over the best chain, a sum of ~70 f32
  distances each rounded differently) within AD_RTOL; measured maxima on
  this workload are 8e-6 and 1.2e-4.
* mixed lengths: the same on reads of 500-3000 bases, some of a genome
  that is not indexed, at a max_num_chunks that most of them pass, so the
  rounds run to the cap and the output takes its loop-exhaustion branch.
* the batch head in row blocks equals the whole batch's head exactly, and
  the JAX package's batch_features (counts and NaNs exactly, features to
  FEAT_ATOL: XLA's CPU backend fuses multiply-adds in the z-scores).
* cross-batch overlap: the four batches give the same records, bit for bit
  apart from mt:, with batch N+1 prepared on the prepare thread while
  batch N maps (set on: these batches are below OVERLAP_MIN_BATCH) and
  with each batch prepared inline; errors of either side reach the caller,
  and close() ends the prepare thread.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from sigmap_tpu_torch.mapping import turbo as port
from _torch_gpu_util import quantize_reads
from _torch_util import (  # noqa: F401 - fixtures
    MIXED_CAP, PARAMS, jax_native_from_source, mixed_workload, workload,
)
from test_torch_events import FEAT_ATOL

PREPARE_THREAD = "sigmap-turbo-prepare"

RTOL = 1e-5
AD_RTOL = 3e-4


def _tags(rec):
    return dict(t.split(":", 1) for t in rec.tags.split("\t"))


def _without_mt(records):
    return [dataclasses.replace(r, tags="\t".join(
        t for t in r.tags.split("\t") if not t.startswith("mt:")))
        for r in records]


def _overlapping_mapper(workload):
    """A mapper of the workload with the overlap on (its read batch is
    below OVERLAP_MIN_BATCH, so it is off by default)."""
    cfg, idx, _, _ = workload
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                              device="cpu")
    assert not mapper._overlap_batches
    mapper._overlap_batches = True
    return mapper


@pytest.fixture(scope="module")
def overlapped(workload):
    """The port's records of the workload with the overlap on, and the
    mapper, closed at the end of the module."""
    mapper = _overlapping_mapper(workload)
    yield mapper, mapper.streaming_map(workload[3])
    mapper.close()


def _jax_records(cfg, idx, signals):
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    return TurboMapper(idx, cfg, TurboParams(peaks_impl="scan", **PARAMS)
                       ).streaming_map(signals)


def _assert_records_match(got, want):
    """Every field and integer tag equal, float tags to RTOL (ad to
    AD_RTOL), mt: aside."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        gt, wt = _tags(g), _tags(w)
        gd.pop("tags"), wd.pop("tags")
        assert gd == wd, (gd, wd)
        assert gt.keys() == wt.keys()
        for k in gt:
            if k == "mt":
                continue
            kind, gv = gt[k].split(":")
            _, wv = wt[k].split(":")
            if kind == "f":
                tol = (AD_RTOL if k == "ad" else RTOL) * abs(float(wv))
                assert abs(float(gv) - float(wv)) <= tol + 2e-6, (k, gv, wv)
            else:
                assert gv == wv, (g.read_name, k, gv, wv)


def _correct(records, reads):
    by_name = {r.read_name: r for r in records}
    return sum(
        1 for r in reads
        if by_name[r.read_id].is_mapped
        and by_name[r.read_id].direction == r.strand
        and by_name[r.read_id].fragment_start < r.ref_end
        and by_name[r.read_id].fragment_start
        + by_name[r.read_id].fragment_length > r.ref_start
    )


def test_port_streaming_map_matches_jax(workload, overlapped):
    cfg, idx, reads, signals = workload
    got = overlapped[1]
    want = _jax_records(cfg, idx, signals)
    assert len(got) == len(signals)
    _assert_records_match(got, want)
    assert _correct(got, reads) >= len(reads) - 2


def test_port_maps_mixed_lengths_as_jax(mixed_workload,
                                        jax_native_from_source):
    """Reads of 500-3000 bases (1-6 chunks) at max_num_chunks 3, some off
    the index: batches of three chunk buckets, reads whose rounds run to
    the cap, and rescues of the off-target reads that overflow (both
    packages' native cores built from one source)."""
    cfg, idx, reads, signals = mixed_workload
    Cs = cfg.mapping.chunk_size
    n_full = [min(s.length // Cs, MIXED_CAP) for s in signals]
    assert sorted(set(n_full)) == [1, 2, MIXED_CAP]
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                              device="cpu")
    try:
        got = mapper.streaming_map(signals)
    finally:
        mapper.close()
    _assert_records_match(got, _jax_records(cfg, idx, signals))
    # the cap was reached: off-target reads at n_full == max_num_chunks
    # never stop and end on the loop-exhaustion branch (ci: the cap)
    capped = [r for r, n in zip(got, n_full) if n == MIXED_CAP
              and r.read_name.startswith("off_")]
    assert any(_tags(r)["ci"] == f"i:{MIXED_CAP}" for r in capped)
    assert mapper.last_pass["rescued"]
    assert _correct(got, reads) >= len(reads) - 2


def _head_inputs(B, NC, Cs, seed):
    """A batch's quantized chunks (as mapping/turbo.py:head_inputs takes
    them), reads with 0 to NC full chunks."""
    rng = np.random.default_rng(seed)
    return (rng.integers(20000, 40000, (B, NC, Cs)).astype(np.int32),
            rng.uniform(-2000, 0, B).astype(np.float32),
            np.full(B, 0.1, np.float32),
            rng.integers(0, NC + 1, B).astype(np.int32))


@pytest.mark.parametrize("B, NC", [(5, 1), (4, 4), (7, 2)],
                         ids=["below", "at", "off"])
def test_blocked_head_matches_whole_and_jax(workload, B, NC):
    """batch_features in blocks of 8 rows (5 rows: one block of 8, padded;
    16 rows: two blocks; 14 rows: a block of 8 and one of 8 padded) equals
    it in one block of all the rows exactly, NaN where both are NaN (a
    chunk of no samples), and the JAX package's batch_features."""
    import jax.numpy as jnp
    from sigmap_tpu.mapping import turbo as jt

    cfg, _, _, _ = workload
    p, ed, cd = port.TurboParams(**PARAMS), cfg.event, \
        cfg.mapping.compress_delta
    ins = _head_inputs(B, NC, 2000, seed=B)
    t = [torch.from_numpy(x) for x in ins]
    assert [s for _, s in port.head_blocks(B * NC, 8)] == {
        5: [8], 16: [8, 8], 14: [8, 8]}[B * NC]
    blocked = port.batch_features(*t, p, ed, cd, block=8)
    whole = port.batch_features(*t, p, ed, cd, block=B * NC)
    for g, w in zip(blocked, whole):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    jf, jc = (np.asarray(x) for x in jt.batch_features(
        jnp.asarray(ins[0].astype(np.uint16)), *map(jnp.asarray, ins[1:]),
        jt.TurboParams(peaks_impl="scan", **PARAMS), ed, cd))
    f = blocked[0].numpy()
    np.testing.assert_array_equal(blocked[1].numpy(), jc)
    np.testing.assert_array_equal(np.isnan(f), np.isnan(jf))
    assert np.isnan(f).any() and not np.isnan(f).all()
    np.testing.assert_allclose(f, jf, rtol=0, atol=FEAT_ATOL)


def test_head_blocks_take_a_fixed_set_of_sizes():
    """Whatever the rows, blocks cover them in order with sizes block // 2^k,
    all but the last of the full size, the last the fewest that hold what
    is left."""
    block = port.HEAD_ROWS
    sizes = set()
    for rows in (1, 2, 1000, 2048, 4096, 6144, 12288, 12289, 24576, 61440,
                 2048 * 30 + 1):
        blocks = port.head_blocks(rows, block)
        assert [s for s, _ in blocks] == list(range(0, rows, block))
        assert all(size == block for _, size in blocks[:-1])
        start, size = blocks[-1]
        assert size >= rows - start and (size == block
                                         or size // 2 < rows - start)
        sizes |= {size for _, size in blocks}
    assert sizes <= {block >> k for k in range(block.bit_length())}


def test_overlap_on_equals_off(workload, overlapped):
    """Every field and tag but mt: equal, floats exactly, with batch N+1
    prepared while batch N maps and with each batch prepared inline."""
    cfg, _, _, signals = workload
    assert -(-len(signals) // cfg.runtime.read_batch) == 4
    mapper, on = overlapped
    mapper._overlap_batches = False
    try:
        off = mapper.streaming_map(signals)
    finally:
        mapper._overlap_batches = True
    assert len(on) == len(off) == len(signals)
    assert _without_mt(on) == _without_mt(off)
    assert all("mt:f:" in r.tags for r in on)


@pytest.mark.parametrize("overlap", [True, False])
def test_last_pass_stamps(workload, overlapped, overlap):
    """streaming_map records where the pass spent its time on the host
    clock: its start, then each of the four batches' rounds, then the wait
    for the rescues, in that order and none overlapping."""
    mapper, _ = overlapped
    mapper._overlap_batches = overlap
    try:
        mapper.streaming_map(workload[3])
    finally:
        mapper._overlap_batches = True
    p = mapper.last_pass
    assert len(p["rounds"]) == 4
    times = [p["start"], *(t for r in p["rounds"] for t in r),
             *p["rescues"]]
    assert times == sorted(times)


def test_overlap_needs_a_large_read_batch(workload):
    """The overlap is on by default from OVERLAP_MIN_BATCH reads a batch,
    off below it, and a mapper may still set it either way."""
    cfg, idx, _, _ = workload
    for B, on in ((port.OVERLAP_MIN_BATCH - 1, False),
                  (port.OVERLAP_MIN_BATCH, True)):
        c = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, read_batch=B))
        mapper = port.TurboMapper(idx, c, port.TurboParams(**PARAMS),
                                  device="cpu")
        try:
            assert mapper._overlap_batches is on
        finally:
            mapper.close()
    assert port.TurboMapper._overlap_batches is True


def _within(seconds, fn):
    """fn() on a thread of its own; fails if it has not returned in time."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _prepare_threads(before):
    return [t for t in threading.enumerate()
            if t.name.startswith(PREPARE_THREAD) and t not in before
            and t.is_alive()]


@pytest.mark.parametrize("where", ["prepare", "round"])
def test_overlap_errors_reach_the_caller(workload, monkeypatch, where):
    """An exception in prepare_batch of batch 2, or in the rounds of batch
    1, reaches the caller of streaming_map; for the rounds' error the next
    batch's preparation has ended first.  The mapper then closes, leaving
    no prepare thread.  The rounds are a stand-in here that records which
    batches it was given (the overlap's order is what is tested); batch
    2's preparation takes half a second longer, so that an error that did
    not wait for it would arrive first."""
    cfg, idx, _, signals = workload
    B = cfg.runtime.read_batch
    batch_of = {id(s): i // B for i, s in enumerate(signals)}
    before = set(threading.enumerate())
    mapper = _overlapping_mapper(workload)
    prepare, prepared, mapped = mapper.prepare_batch, [], []

    def prepare_batch(batch, stream=None, *pass_spans):
        i = batch_of[id(batch[0])]
        if i == 2:
            if where == "prepare":
                raise RuntimeError("prepare failed")
            time.sleep(0.5)
        out = prepare(batch, stream, *pass_spans)
        prepared.append(i)
        return out

    def map_batch(batch, base, records, prep):
        assert isinstance(prep, port.PreparedBatch)
        mapped.append(base // B)
        if where == "round" and base // B == 1:
            raise ValueError("round failed")

    monkeypatch.setattr(mapper, "prepare_batch", prepare_batch)
    monkeypatch.setattr(mapper, "_map_batch", map_batch)
    err = RuntimeError if where == "prepare" else ValueError
    with pytest.raises(err, match=f"{where} failed"):
        _within(120, lambda: mapper.streaming_map(signals))
    if where == "prepare":
        assert (prepared, mapped) == ([0, 1], [0, 1])
    else:
        assert (prepared, mapped) == ([0, 1, 2], [0, 1])
    assert _prepare_threads(before)
    _within(60, mapper.close)
    assert _prepare_threads(before) == []


def test_close_ends_the_prepare_thread(workload):
    """close() after a batch was prepared on the prepare thread leaves no
    live prepare thread."""
    cfg, idx, _, signals = workload
    before = set(threading.enumerate())
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                              device="cpu")
    fut = mapper._prep_pool.submit(mapper.prepare_batch,
                                   signals[: cfg.runtime.read_batch])
    assert isinstance(fut.result(timeout=120), port.PreparedBatch)
    assert len(_prepare_threads(before)) == 1
    _within(60, mapper.close)
    assert _prepare_threads(before) == []


@pytest.mark.parametrize("NC", [1, 4])
def test_quantize_matches_jax(workload, NC):
    """The port's quantization (host staging, then the device half, here on
    the CPU) gives the JAX package's host quantization exactly on every
    branch, at a chunk count that cuts the long reads (NC=1: the fallback
    affine spans only the first chunk) and at one that does not."""
    from sigmap_tpu.mapping.turbo import quantize_batch

    reads = quantize_reads(workload[3])
    B, Cs = len(reads) + 3, 4000
    want = quantize_batch(reads, B, NC, Cs, 30)
    dac_scale = np.float32(reads[0].range / reads[0].digitisation)
    fallback = [6, 7, 8, 12]          # noisy, nodig, offset, flat
    assert (want[2][fallback] != dac_scale).all()
    assert (want[2][:6] == dac_scale).all()
    pa, L, scale, off, n_full = port.stage_batch(reads, B, NC, Cs, 30)
    pa[L[:, None] <= np.arange(NC * Cs)[None, :]] = 7.0   # stale samples
    q, qoff, qscale = port.quantize(pa, L, scale, off)
    got = (q.numpy().reshape(B, NC, Cs), qoff.numpy(), qscale.numpy(),
           n_full)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].dtype == got[2].dtype == np.float32
    assert got[3].dtype == np.int32
