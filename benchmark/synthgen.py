"""The benchmark's generator: genomes, the pore model and simulated reads.

A frozen copy of ``sigmap_tpu_torch.synth`` and of the synthetic pore model
(``io/pore_model.py:make_synthetic_pore_model`` and ``expected_signal``),
with the reads of a pool simulated in a few large numpy calls rather than
one read at a time.  Everything is drawn from the run's ``--seed`` through
named streams (``streams``), so the same seed gives the same genome, pool
and sample, and two streams never share draws.

Reads are what ``io/signals.py`` would hand the mapper: DAC values
(int16) converted to pA with ``(raw + offset) * range / digitisation``, and
samples outside (30, 200) pA dropped.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

import numpy as np

# stream ids under one seed (numpy SeedSequence spawn keys)
STREAMS = {"genome": 1, "off_genome": 2, "pool": 3, "order": 4, "sample": 5}


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named stream of ``seed`` (any integer >= 0)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), STREAMS[stream]]))


# ---- pore model (io/pore_model.py, frozen) --------------------------------

@dataclass
class Pore:
    k: int
    level_mean: np.ndarray   # f32 [4^k]


def synthetic_pore(k: int = 6, seed: int = 0) -> Pore:
    """make_synthetic_pore_model's level means (the stdv columns are not
    used by mapping)."""
    rng = np.random.default_rng(seed)
    size = 1 << (2 * k)
    idx = np.arange(size)
    base = np.zeros(size, np.float64)
    for j in range(k):
        b = (idx >> (2 * (k - 1 - j))) & 3
        w = 6.0 if abs(j - k / 2) <= 1 else 2.0
        base += w * (b - 1.5)
    level_mean = 90.0 + base + rng.normal(0, 4.0, size)
    return Pore(k, level_mean.astype(np.float32))


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit packed k-mers at every start of ``codes`` (ambiguous -> A)."""
    b = np.where(codes < 4, codes, 0).astype(np.int64)
    n = len(b) - k + 1
    out = np.zeros(max(n, 0), np.int64)
    for i in range(k):
        out = (out << 2) | b[i: i + n]
    return out


def expected_signal(pore: Pore, codes: np.ndarray) -> np.ndarray:
    """Per-position level means with the reference's rolling-hash quirk:
    out[0] from the k-mer at 0, out[i >= 1] from the k-mer at i + 1 (an A
    shifted in past the end)."""
    k = pore.k
    padded = np.concatenate([codes, np.zeros(1, np.uint8)])
    km = kmer_codes(padded, k)
    idx = np.empty(len(codes) - k + 1, np.int64)
    idx[0] = km[0]
    idx[1:] = km[2: len(codes) - k + 2]
    return pore.level_mean[idx]


def revcomp(codes: np.ndarray) -> np.ndarray:
    rc = (3 ^ codes[::-1]).astype(np.uint8)
    rc[codes[::-1] > 3] = 4
    return rc


# ---- genomes ---------------------------------------------------------------

def random_contigs(contigs, rng: np.random.Generator):
    """[(name, length)] -> [(name, uint8 codes)] of uniform random bases."""
    return [(name, rng.integers(0, 4, size=int(n), dtype=np.uint8))
            for name, n in contigs]


# ---- reads -----------------------------------------------------------------

@dataclass
class Truth:
    """Where a simulated read came from (off-target reads: ref_index -1)."""

    read_id: str
    ref_index: int
    ref_start: int
    ref_end: int
    strand: int              # 1 = forward
    on_target: bool


DIGITISATION = 8192.0
DAC_RANGE = 1400.0
DAC_OFFSET = 10.0
PA_LO, PA_HI = 30.0, 200.0


def read_lengths(spec: dict, n: int) -> np.ndarray:
    """Bases of ``n`` reads.  ``fixed``: all ``bases``.  ``lognormal``: the
    n quantiles (i + 0.5) / n of a log-normal of ``median`` and ``sigma``,
    clipped to ``clip``, so every seed gets the same set of lengths (the
    seed only orders them)."""
    if spec["kind"] == "fixed":
        return np.full(n, int(spec["bases"]), np.int64)
    if spec["kind"] == "lognormal":
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
        lo, hi = spec["clip"]
        b = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
        return np.clip(b, lo, hi).astype(np.int64)
    raise ValueError(f"unknown read length kind {spec['kind']!r}")


def _kmer_table(genome, k: int):
    """Packed k-mer codes at every start of each contig and of its reverse
    complement, concatenated: (codes, forward offsets, reverse offsets)."""
    parts, off_f, off_r = [], [], []
    n = 0
    for _, codes in genome:
        off_f.append(n)
        parts.append(kmer_codes(codes, k))
        n += len(parts[-1])
    for _, codes in genome:
        off_r.append(n)
        parts.append(kmer_codes(revcomp(codes), k))
        n += len(parts[-1])
    return np.concatenate(parts), np.array(off_f), np.array(off_r)


def fragment_kmers(km: np.ndarray, p0: int, b: int, k: int) -> np.ndarray:
    """The k-mer codes ``expected_signal`` reads for a fragment of b + k - 1
    bases whose first k-mer is ``km[p0]`` in a ``_kmer_table``: the first,
    then those at 2..b-1, then the last with an A shifted in."""
    idx = np.empty(b, np.int64)
    idx[0] = km[p0]
    idx[1: b - 1] = km[p0 + 2: p0 + b]
    idx[b - 1] = (int(km[p0 + b - 1]) << 2) & ((1 << (2 * k)) - 1)
    return idx


def simulate_pool(pore: Pore, genome, other, bases: np.ndarray,
                  off: np.ndarray, rng: np.random.Generator,
                  samples_per_base: float, noise_pa: float, device="cpu"):
    """Reads of ``bases[i]`` bases, from ``other`` where ``off[i]``, else
    from ``genome``: a fragment at a uniform start on a random strand, its
    expected levels (``expected_signal`` of the fragment, gathered from
    the contigs' k-mer tables), per base a Poisson dwell (at least 1)
    around ``samples_per_base``, Gaussian noise of ``noise_pa``, digitised
    like a device and converted back to pA.  Starts and strands come from
    ``rng``; the dwells and the noise are drawn in one call each by a
    torch generator on ``device`` seeded from ``rng``.  Returns (ids, pa
    arrays, truths)."""
    import torch

    k = pore.k
    n = len(bases)
    tables = [_kmer_table(g, k) if g is not None else None
              for g in (genome, other)]
    src = off.astype(np.int64)
    nref = np.array([len(genome), len(other) if other is not None else 1])
    ref = (rng.random(n) * nref[src]).astype(np.int64)
    lens = np.array([len((other if o else genome)[r][1])
                     for o, r in zip(off, ref)])
    starts = (rng.random(n) * np.maximum(1, lens - bases - k)).astype(np.int64)
    strands = rng.integers(0, 2, n)
    idx = np.empty(int(bases.sum()), np.int64)
    at = 0
    for i in range(n):
        km, off_f, off_r = tables[src[i]]
        b, s = int(bases[i]), int(starts[i])
        if strands[i] == 1:
            p0 = off_f[ref[i]] + s
        else:
            p0 = off_r[ref[i]] + lens[i] - s - b - k + 1
        idx[at: at + b] = fragment_kmers(km, p0, b, k)
        at += b
    dev = torch.device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(int(rng.integers(0, 2**62)))
    levels = torch.from_numpy(pore.level_mean[idx]).to(dev)
    dwell = torch.poisson(torch.full(levels.shape, samples_per_base,
                                     device=dev), generator=gen)
    dwell = torch.clamp(dwell, min=1).to(torch.int64)
    samples = torch.repeat_interleave(levels, dwell)
    samples += torch.randn(samples.shape, generator=gen, device=dev) \
        * noise_pa
    scale = np.float32(DAC_RANGE / DIGITISATION)
    raw = torch.clamp(torch.round(samples / float(scale) - DAC_OFFSET),
                      -32768, 32767).to(torch.int16)
    del samples
    pa = (raw.to(torch.float32) + DAC_OFFSET) * float(scale)
    read_of_base = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.from_numpy(bases).to(dev))
    read_of = torch.repeat_interleave(read_of_base, dwell)
    keep = (pa > PA_LO) & (pa < PA_HI)
    counts = torch.bincount(read_of[keep], minlength=n).cpu().numpy()
    pa = pa[keep].cpu().numpy()
    ends = np.cumsum(counts)
    ids, pas, truths = [], [], []
    for i in range(n):
        rid = f"{'off' if off[i] else 'read'}_{i:06d}"
        ids.append(rid)
        pas.append(pa[ends[i] - counts[i]: ends[i]])
        truths.append(Truth(
            rid, -1 if off[i] else int(ref[i]), int(starts[i]),
            int(starts[i] + bases[i] + k - 1), int(strands[i]), not off[i]))
    return ids, pas, truths


def score_hits(records, truths):
    """(mapped, correct) of records (read_name, strand '+'/'-', ref_index,
    start, end) against the truths of the same reads: correct = same
    contig and strand, overlapping the true interval (chip_smoke.py's
    ``score_hits``)."""
    by_id = {t.read_id: t for t in truths}
    mapped = correct = 0
    for name, strand, ref_index, lo, hi in records:
        t = by_id[name]
        mapped += 1
        if (t.on_target and ref_index == t.ref_index
                and (strand == "+") == (t.strand == 1)
                and lo < t.ref_end and hi > t.ref_start):
            correct += 1
    return mapped, correct
