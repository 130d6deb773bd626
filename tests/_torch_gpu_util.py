"""Inputs and fixtures of tests/test_torch_gpu.py, built with the port's own
host modules (``sigmap_tpu_torch.synth``, ``index.build``, ``io``): nothing
here imports the JAX package, jax, jaxlib or h5py, so the file also runs
where the GPU is and JAX is not, with ``--noconftest``.  Each input is the
one its original test used (named in its docstring), reads written as BLOW5
where that test wrote FAST5."""

import numpy as np
import pytest
import torch

from sigmap_tpu_torch.config import IndexConfig, RuntimeConfig, SigmapConfig
from sigmap_tpu_torch.index.build import build_index
from sigmap_tpu_torch.io.fasta import ReferenceSequence
from sigmap_tpu_torch.io.pore_model import make_synthetic_pore_model
from sigmap_tpu_torch.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu_torch.io.slow5 import COMP_ZLIB, SIGCOMP_NONE, write_blow5
from sigmap_tpu_torch.synth import (genome_to_fasta_str, random_genome,
                                    simulate_reads)

RADIUS = 0.08      # tests/test_chain_fused.py
DIM = 6
# tests/test_torch_driver.py's exact-engine configuration
DRIVER_CFG = SigmapConfig(
    runtime=RuntimeConfig(
        read_batch=8, seeds_per_tile=32, cap_per_seed=8192,
        surv_per_tile=65536, matches_per_tile=16384,
    )
)
# tests/test_torch_seeding.py's search budgets: roomy, and tight enough to
# overflow
SEARCH_RADIUS = 0.08
SEARCH_KW = dict(seeds_per_tile=16, cap_per_seed=8192, surv_per_tile=16384,
                 matches_per_tile=8192)
SEARCH_TIGHT = dict(seeds_per_tile=16, cap_per_seed=256, surv_per_tile=32,
                    matches_per_tile=8)


def quantize_reads(signals):
    """signals' first six reads (DAC-derived) and reads that take every
    other branch of the transport quantization: not from a DAC (noise
    added), no digitisation, raw values outside 0..65535 (a large offset),
    empty, shorter than a chunk, longer than four chunks, constant.  Reads
    6, 7, 8 and 12 take the fallback affine."""
    rng = np.random.default_rng(3)
    out = list(signals[:6])
    s = signals[0]
    noisy = (s.pa + rng.normal(0, 0.01, s.length)).astype(np.float32)
    out += [
        ReadSignal("noisy", s.digitisation, s.range, s.offset, noisy),
        ReadSignal("nodig", 0.0, s.range, s.offset, s.pa.copy()),
        ReadSignal("offset", s.digitisation, s.range, s.offset + 70000.0,
                   s.pa.copy()),
        ReadSignal("empty", s.digitisation, s.range, s.offset,
                   np.zeros(0, np.float32)),
        ReadSignal("short", s.digitisation, s.range, s.offset, s.pa[:1500]),
        ReadSignal("long", s.digitisation, s.range, s.offset,
                   np.concatenate([s.pa] * 6)),
        ReadSignal("flat", 0.0, s.range, s.offset,
                   np.full(5000, 91.25, np.float32)),
    ]
    return out


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test is skipped where there is none (the
    decision is taken when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_chain_case(rng, A, B, CARRY, density=0.7, n_groups=4,
                      clustered=True):
    """tests/test_chain_fused.py:_random_case: anchors roughly emulating
    seeding output (qpos-major rows, K-slot runs sharing qpos, target
    positions drifting with query) and a random carry."""
    a_t = np.zeros((A, B), np.int32)
    a_q = np.zeros((A, B), np.int32)
    a_d = np.zeros((A, B), np.float32)
    a_g = np.full((A, B), -1, np.int32)
    for b in range(B):
        q = 2
        base_t = rng.integers(100, 5000, n_groups)
        for i in range(A):
            if i % 4 == 0:
                q += int(rng.integers(1, 4))
            if rng.random() > density:
                continue
            g = int(rng.integers(0, n_groups))
            if clustered and rng.random() < 0.7:
                t = base_t[g] + q * 2 + int(rng.integers(-3, 4))
            else:
                t = int(rng.integers(0, 8000))
            a_t[i, b] = t
            a_q[i, b] = q
            a_d[i, b] = rng.random() * RADIUS
            a_g[i, b] = g
    c_score = rng.random((CARRY, B)).astype(np.float32) * 20
    c_stt = rng.integers(0, 4000, (CARRY, B)).astype(np.int32)
    c_stq = rng.integers(0, 50, (CARRY, B)).astype(np.int32)
    c_n = rng.integers(1, 20, (CARRY, B)).astype(np.int32)
    c_sumd = rng.random((CARRY, B)).astype(np.float32)
    for b in range(B):
        for i in range(CARRY):
            if rng.random() < 0.5:
                a_g[i, b] = -1
                continue
            a_g[i, b] = int(rng.integers(0, n_groups))
            a_q[i, b] = i // 8
            a_t[i, b] = int(rng.integers(0, 6000))
            a_d[i, b] = rng.random() * RADIUS
    return (a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd)


def kernels_case(seed=42):
    """tests/test_torch_events.py:_kernels_case (tests/test_kernels.py:13):
    6 raw rows of 1200 samples, ragged lengths."""
    rng = np.random.default_rng(seed)
    B, C = 6, 1200
    sigs = rng.normal(80, 8, (B, C)).astype(np.float32)
    for b in range(B):
        for s in range(0, C, 9):
            sigs[b, s: s + 9] += rng.normal(0, 6)
    return sigs, np.array([C, C - 100, 500, C, 50, 7], np.int32)


def ragged_pairs(seed=42, B=4, T=256, Q=64):
    """tests/test_torch_sdtw.py:_ragged: ragged sDTW pairs and one whose
    query is longer than its target."""
    rng = np.random.default_rng(seed)
    ts = np.zeros((B + 1, T), np.float32)
    qs = np.zeros((B + 1, Q), np.float32)
    tl = np.zeros(B + 1, np.int32)
    ql = np.zeros(B + 1, np.int32)
    for b in range(B):
        nt = int(rng.integers(100, T))
        nq = int(rng.integers(30, Q))
        t = rng.normal(0, 1, nt).astype(np.float32)
        lo = int(rng.integers(0, nt - nq))
        q = (t[lo: lo + nq] + rng.normal(0, 0.05, nq)).astype(np.float32)
        ts[b, :nt], qs[b, :nq], tl[b], ql[b] = t, q, nt, nq
    ts[B, :40] = rng.normal(0, 1, 40)
    qs[B, :] = rng.normal(0, 1, Q)
    tl[B], ql[B] = 40, Q
    return ts, tl, qs, ql


def uniform_pairs(seed=3, B=5, T=120, Q=48):
    """tests/test_torch_sdtw.py:_uniform."""
    rng = np.random.default_rng(seed)
    ts = rng.normal(0, 1, (B, T)).astype(np.float32)
    qs = rng.normal(0, 1, (B, Q)).astype(np.float32)
    return ts, np.full(B, T, np.int32), qs, np.full(B, Q, np.int32)


@pytest.fixture(scope="module")
def gpu_pore():
    """tests/conftest.py:pore6."""
    return make_synthetic_pore_model(k=6, seed=0)


@pytest.fixture(scope="module")
def gpu_genome():
    """tests/conftest.py:tiny_genome: 100 kb."""
    return random_genome(length=100_000, seed=7)


@pytest.fixture(scope="module")
def search_setup(gpu_pore, gpu_genome):
    """tests/test_torch_seeding.py:setup: the 100 kb index, 40 noisy index
    windows and 8 pure-noise queries."""
    seqs = [ReferenceSequence(n, c) for n, c in gpu_genome]
    idx = build_index(seqs, gpu_pore, IndexConfig(), verbose=False)
    rng = np.random.default_rng(3)
    W = np.lib.stride_tricks.sliding_window_view(idx.values, idx.dim)
    qi = rng.integers(0, idx.n_windows, 40)
    noisy = W[qi] + rng.normal(0, 0.1, (40, idx.dim)).astype(np.float32)
    pure = rng.normal(0, 1, (8, idx.dim)).astype(np.float32)
    queries = np.concatenate([noisy, pure]).astype(np.float32)
    q8 = np.zeros((len(queries), 8), np.float32)
    q8[:, : idx.dim] = queries
    return idx, q8


@pytest.fixture(scope="module")
def driver_setup(gpu_pore, gpu_genome):
    """tests/test_torch_driver.py:setup: the 100 kb index and 8 reads of
    1500 bases."""
    seqs = [ReferenceSequence(n, c) for n, c in gpu_genome]
    idx = build_index(seqs, gpu_pore, DRIVER_CFG.index, verbose=False)
    reads = simulate_reads(gpu_pore, gpu_genome, 8, seed=21, read_bases=1500)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    return idx, reads, signals


@pytest.fixture(scope="module")
def debug_work(tmp_path_factory):
    """tests/test_torch_debug_modes.py:work: 3 reads against a 2-sequence
    genome of two lengths, the reads as BLOW5."""
    tmp = tmp_path_factory.mktemp("debug")
    pore = make_synthetic_pore_model(k=6, seed=0)
    g0, g1 = random_genome(420, seed=31, n_seqs=2)
    genome = [g0, (g1[0], g1[1][:300])]
    (tmp / "ref.fa").write_text(genome_to_fasta_str(genome))
    pore.save(str(tmp / "pore.model"))
    reads = simulate_reads(pore, genome, 3, seed=32, read_bases=60)
    sig = tmp / "sigs"
    sig.mkdir()
    write_blow5(str(sig / "r.blow5"),
                [dict(read_id=r.read_id, raw=r.raw,
                      digitisation=r.digitisation, range=r.range,
                      offset=r.offset) for r in reads],
                rec_comp=COMP_ZLIB, sig_comp=SIGCOMP_NONE)
    return str(tmp / "ref.fa"), str(tmp / "pore.model"), str(sig), tmp


@pytest.fixture(scope="module")
def sweep_index():
    """tests/test_torch_sweep.py:small_index: a 20 kb index."""
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(20000, seed=3)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    return cfg, idx


def closest_k_queries(idx, n_windows):
    """tests/test_torch_sweep.py:_queries(setup="closest_k"): 32 noisy
    copies of index windows, K = 4."""
    if idx.win_group is None:
        idx.derive_window_metadata()
    W = np.lib.stride_tricks.sliding_window_view(idx.values, idx.dim)
    rng = np.random.default_rng(7)
    Q = 32
    picks = rng.integers(0, n_windows, Q)
    qs = np.zeros((Q, 8), np.float32)
    qs[:, : idx.dim] = W[picks] + rng.normal(
        0, 0.1, (Q, idx.dim)).astype(np.float32)
    return qs, 4
