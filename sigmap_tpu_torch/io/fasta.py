"""FASTA(.gz) reading and reverse-complement preparation.

Replaces the reference's kseq/zlib loader (sequence_batch.cc:86-124) and
PrepareNegativeSequenceAt (sequence_batch.h:66-77) with a host-side reader
producing numpy 2-bit-codeable byte arrays.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from ..utils import CODE_TO_CHAR, encode_bases, revcomp_codes


@dataclass
class ReferenceSequence:
    name: str
    codes: np.ndarray            # uint8 codes {0..4}, positive strand
    neg_codes: np.ndarray = field(default=None)  # reverse complement codes

    @property
    def length(self) -> int:
        return len(self.codes)

    def prepare_negative(self) -> None:
        if self.neg_codes is None:
            self.neg_codes = revcomp_codes(self.codes)

    def seq_str(self) -> str:
        return CODE_TO_CHAR[self.codes].tobytes().decode()


def read_fasta(path: str) -> list[ReferenceSequence]:
    """Load all sequences (reference: SequenceBatch::LoadAllSequences)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    seqs: list[ReferenceSequence] = []
    name = None
    parts: list[bytes] = []
    with opener(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    seqs.append(
                        ReferenceSequence(name, encode_bases(b"".join(parts)))
                    )
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
    if name is not None:
        seqs.append(ReferenceSequence(name, encode_bases(b"".join(parts))))
    if not seqs:
        raise ValueError(f"no sequences found in {path}")
    for s in seqs:
        s.prepare_negative()
    return seqs


def write_fasta(path: str, records: list[tuple[str, str]], width: int = 80) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")
