"""ONT k-mer pore model: TSV loading and sequence->expected-signal conversion.

Replaces PoreModel (pore_model.cc:11-81) with a vectorized table-gather
implementation.  The conversion deliberately reproduces a behavioral quirk of
the reference's rolling hash (pore_model.cc:70-79): after the first output
position, the shifted-in base is `sequence[position + k]` rather than
`sequence[position + k - 1]`, so every output i >= 1 carries the level mean of
the k-mer starting at i+1 (with a virtual 'A' shifted in past the sequence
end, where the C++ reads the NUL terminator).  Reproducing this is required
for position-exact output parity with the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import rolling_kmer_codes


@dataclass
class PoreModel:
    k: int
    level_mean: np.ndarray  # float32[4^k]
    level_stdv: np.ndarray  # float32[4^k]
    sd_mean: np.ndarray
    sd_stdv: np.ndarray

    @staticmethod
    def load(path: str) -> "PoreModel":
        """Parse an ONT model TSV (header lines starting with '#' or 'kmer'
        skipped; columns: kmer level_mean level_stdv sd_mean sd_stdv ...).

        Reference: PoreModel::Load (pore_model.cc:11-44).
        """
        k = None
        lm = ls = sm = ss = None
        n = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or line.startswith("kmer"):
                    continue
                cols = line.split()
                kmer = cols[0]
                if k is None:
                    k = len(kmer)
                    size = 1 << (2 * k)
                    lm = np.zeros(size, np.float32)
                    ls = np.zeros(size, np.float32)
                    sm = np.zeros(size, np.float32)
                    ss = np.zeros(size, np.float32)
                idx = 0
                for c in kmer:
                    idx = (idx << 2) | "ACGT".index(c)
                vals = [float(x) for x in cols[1:5]] + [0.0] * 4
                lm[idx], ls[idx], sm[idx], ss[idx] = vals[:4]
                n += 1
        if k is None:
            raise ValueError(f"no kmers found in pore model {path}")
        return PoreModel(k, lm, ls, sm, ss)

    def save(self, path: str) -> None:
        size = 1 << (2 * self.k)
        with open(path, "w") as f:
            f.write("kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv\n")
            for i in range(size):
                kmer = "".join(
                    "ACGT"[(i >> (2 * (self.k - 1 - j))) & 3]
                    for j in range(self.k)
                )
                f.write(
                    f"{kmer}\t{self.level_mean[i]:.6f}\t{self.level_stdv[i]:.6f}"
                    f"\t{self.sd_mean[i]:.6f}\t{self.sd_stdv[i]:.6f}\n"
                )

    def expected_signal(self, codes: np.ndarray) -> np.ndarray:
        """Sequence codes -> per-position expected level means, float32[L-k+1].

        Matches GetLevelMeansAt(seq, 0, L) including its off-by-one rolling
        update (see module docstring):
          out[0]   = level_mean[kmer(codes[0:k])]
          out[i>0] = level_mean[kmer(codes[i+1 : i+1+k])]  (A-padded past end)
        """
        k = self.k
        L = len(codes)
        if L < k:
            raise ValueError("sequence shorter than k")
        padded = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])
        kmers = rolling_kmer_codes(padded, k)  # [L+1-k+1] = [L-k+2]
        idx = np.empty(L - k + 1, dtype=np.int64)
        idx[0] = kmers[0]
        idx[1:] = kmers[2 : L - k + 2]
        return self.level_mean[idx]


def make_synthetic_pore_model(k: int = 6, seed: int = 0) -> PoreModel:
    """Deterministic synthetic k-mer model for tests and benchmarks.

    The real ONT models (extern/kmer_models) are not vendored here; this
    produces level means with realistic spread (~60-120 pA) where the level
    depends smoothly on base composition plus pseudo-random variation, similar
    in distribution to r9.4 template_median68pA.model.
    """
    rng = np.random.default_rng(seed)
    size = 1 << (2 * k)
    idx = np.arange(size)
    base_contrib = np.zeros(size, np.float64)
    for j in range(k):
        b = (idx >> (2 * (k - 1 - j))) & 3
        # central bases dominate the level, like real pores
        w = 6.0 if abs(j - k / 2) <= 1 else 2.0
        base_contrib += w * (b - 1.5)
    level_mean = 90.0 + base_contrib + rng.normal(0, 4.0, size)
    level_stdv = np.abs(rng.normal(1.5, 0.3, size)) + 0.5
    return PoreModel(
        k,
        level_mean.astype(np.float32),
        level_stdv.astype(np.float32),
        np.full(size, 1.0, np.float32),
        np.full(size, 0.1, np.float32),
    )
