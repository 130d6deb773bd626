"""Shared helpers of the tests/test_torch_*.py files."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import sigmap_tpu.native as jax_native
from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu.synth import random_genome, simulate_read, simulate_reads
from sigmap_tpu_torch import _build

# the suite runs several workers side by side: keep each one's intra-op
# thread pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

# the turbo shapes of tests/test_turbo.py
PARAMS = dict(S=256, K=16, RING=64, TILE=256)


@pytest.fixture
def jax_native_from_source(tmp_path_factory, monkeypatch):
    """For the length of the test, sigmap_tpu.native runs a build of its own
    source, native/core.cc, made with the port's compiler flags
    (_build.NATIVE_CXXFLAGS) in a temporary directory.  The binary that lies
    in sigmap_tpu/_native/ is whatever the host built at some time with the
    host's flags, so it may round differently (FMA contraction); source
    against source, the two packages agree exactly.  Both `_SO` and the
    cached handle `_lib` are replaced and restored: an earlier test of the
    same process may have loaded the other binary already."""
    so = _build.native_library(
        Path(__file__).resolve().parent.parent / "native" / "core.cc",
        tmp_path_factory.getbasetemp() / "jax_native")
    monkeypatch.setattr(jax_native, "_SO", so)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.available(), "native/core.cc did not build or load"
    return so


@pytest.fixture(scope="module")
def workload():
    """tests/test_turbo.py:17-31: 200 kb genome, 100 reads of 2000 bases,
    read batch 32."""
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(200_000, seed=11)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    reads = simulate_reads(pore, genome, 100, seed=5, read_bases=2000)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=32))
    return cfg, idx, reads, signals


# the mixed-length workload: reads of 500-3000 bases, some of a genome
# that is not indexed, at a chunk cap that most reads pass
MIXED_ON, MIXED_OFF = 40, 8
MIXED_CAP = 3
MIXED_BATCH = 16


def _signal(r):
    return ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                      dac_to_pa(r.raw, r.digitisation, r.range, r.offset))


@pytest.fixture(scope="module")
def mixed_workload(workload):
    """The 200 kb workload's index with MIXED_ON reads of its genome and
    MIXED_OFF off-target reads (named ``off_*``) of a 50 kb random genome
    that is not indexed, in a shuffled order; each read's length drawn with
    numpy, uniform in 500-3000 bases; max_num_chunks lowered to MIXED_CAP
    (reads from ~1,350 bases pass it), read batch MIXED_BATCH.  Returns
    (cfg, idx, on-target reads, signals)."""
    cfg, idx, _, _ = workload
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(200_000, seed=11)
    other = random_genome(50_000, seed=12)
    rng = np.random.default_rng(7)
    lengths = rng.integers(500, 3001, MIXED_ON + MIXED_OFF)
    reads = [simulate_read(pore, genome if i < MIXED_ON else other, rng,
                           f"{'read' if i < MIXED_ON else 'off'}_{i:03d}",
                           int(n))
             for i, n in enumerate(lengths)]
    order = rng.permutation(len(reads))
    signals = [_signal(reads[i]) for i in order]
    cfg = dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping,
                                         max_num_chunks=MIXED_CAP),
        runtime=dataclasses.replace(cfg.runtime, read_batch=MIXED_BATCH))
    return cfg, idx, reads[:MIXED_ON], signals
