"""Synthetic genomes, pore models and simulated raw reads.

The reference repo carries no test data (and its extern/ submodules with the
real ONT models are not vendored), so tests and benchmarks synthesize:
  * a random genome;
  * a deterministic synthetic k-mer model (io.pore_model.make_synthetic_pore_model);
  * raw reads simulated from the genome: per-base dwell times around
    sample_rate / bp_per_sec (~8.9 samples/base, sigmap.cc:637-639), Gaussian
    current noise around the k-mer level mean, digitised like a real device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .io.pore_model import PoreModel
from .utils import CODE_TO_CHAR, revcomp_codes


def random_genome(length: int, seed: int = 0, n_seqs: int = 1) -> list[tuple[str, np.ndarray]]:
    """Random uint8-code genome sequences [(name, codes)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_seqs):
        codes = rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)
        out.append((f"synth_{i}", codes))
    return out


def genome_to_fasta_str(genome: list[tuple[str, np.ndarray]]) -> str:
    parts = []
    for name, codes in genome:
        parts.append(f">{name}")
        s = CODE_TO_CHAR[codes].tobytes().decode()
        parts.extend(s[i : i + 80] for i in range(0, len(s), 80))
    return "\n".join(parts) + "\n"


@dataclass
class SimulatedRead:
    read_id: str
    raw: np.ndarray          # int16 DAC values
    digitisation: float
    range: float
    offset: float
    # ground truth
    ref_index: int
    ref_start: int
    ref_end: int
    strand: int              # 1 = forward


def simulate_read(
    pore: PoreModel,
    genome: list[tuple[str, np.ndarray]],
    rng: np.random.Generator,
    read_id: str,
    read_bases: int = 3000,
    samples_per_base: float = 8.89,
    noise_pa: float = 1.2,
    digitisation: float = 8192.0,
    dac_range: float = 1400.0,
    offset: float = 10.0,
) -> SimulatedRead:
    ref_index = int(rng.integers(0, len(genome)))
    name, codes = genome[ref_index]
    L = len(codes)
    start = int(rng.integers(0, max(1, L - read_bases - pore.k)))
    strand = int(rng.integers(0, 2))
    frag = codes[start : start + read_bases + pore.k - 1]
    if strand == 0:
        frag = revcomp_codes(frag)
    levels = pore.expected_signal(frag)  # [read_bases]
    dwell = np.maximum(
        1, rng.poisson(samples_per_base, size=len(levels))
    )
    pa = np.repeat(levels, dwell) + rng.normal(0, noise_pa, int(dwell.sum()))
    scale = dac_range / digitisation
    raw = np.clip(np.round(pa / scale - offset), -32768, 32767).astype(np.int16)
    return SimulatedRead(
        read_id, raw, digitisation, dac_range, offset,
        ref_index, start, start + read_bases + pore.k - 1, strand,
    )


def simulate_reads(
    pore: PoreModel,
    genome: list[tuple[str, np.ndarray]],
    n_reads: int,
    seed: int = 1,
    read_bases: int = 3000,
    **kw,
) -> list[SimulatedRead]:
    rng = np.random.default_rng(seed)
    return [
        simulate_read(pore, genome, rng, f"read_{i:05d}", read_bases, **kw)
        for i in range(n_reads)
    ]
