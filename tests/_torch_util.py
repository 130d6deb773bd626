"""Shared helpers of the tests/test_torch_*.py files."""

import dataclasses
from pathlib import Path

import pytest
import torch

import sigmap_tpu.native as jax_native
from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu.synth import random_genome, simulate_reads
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
