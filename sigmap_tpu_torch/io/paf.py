"""Uncalled-style PAF output with the reference's exact field and tag layout.

Replaces OutputTools/PAFOutputTools (output_tools.h:190-212,334-355) and the
tag assembly in the mapping drivers (sigmap.cc:403-415,731-745,825-858).

Float tags are rendered like C++ std::to_string(float) ("%f", 6 decimals).
Note the reference quirk: in the *batch* driver's unmapped branch, s1/s2 are
emitted from integer zero (sigmap.cc:523-524) and so print as "0", while in
the streaming driver they come from float expressions and print "0.000000".
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils import fmt_float


@dataclass
class PAFRecord:
    read_id: int
    read_name: str
    read_length: int
    read_start: int
    read_end: int
    ref_index: int               # index into the reference batch
    fragment_start: int
    fragment_length: int
    mapq: int                    # 61 == unmapped sentinel (sigmap.cc:529,864)
    direction: int               # 1 = '+', 0 = '-'
    tags: str = ""

    @property
    def is_mapped(self) -> bool:
        return self.mapq <= 60


def mapped_line(rec: PAFRecord, ref_name: str, ref_length: int) -> str:
    """PAFOutputTools<PAFMapping>::AppendMapping (output_tools.h:334-355)."""
    strand = "+" if rec.direction == 1 else "-"
    end = rec.fragment_start + rec.fragment_length
    return (
        f"{rec.read_name}\t{rec.read_length}\t{rec.read_start}\t{rec.read_end}"
        f"\t{strand}\t{ref_name}\t{ref_length}\t{rec.fragment_start}\t{end}"
        f"\t{rec.read_length}\t{rec.fragment_length}\t{rec.mapq}\t{rec.tags}\n"
    )


def unmapped_line(rec: PAFRecord) -> str:
    """OutputTools::AppendUnmappedRead (output_tools.h:200-210)."""
    return (
        f"{rec.read_name}\t{rec.read_length}"
        f"\t*\t*\t*\t*\t*\t*\t*\t*\t*\t{rec.mapq}\t{rec.tags}\n"
    )


def streaming_tags(
    mapping_time_ms: float,
    num_chunks: int,
    signal_length: int,
    chains_summary: "ChainsSummary | None",
) -> str:
    """Tag string for StreamingMap (sigmap.cc:731-745 mapped;
    sigmap.cc:825-858 unmapped — chain stats included iff chains exist)."""
    parts = [
        "mt:f:" + fmt_float(mapping_time_ms),
        "ci:i:" + str(num_chunks),
        "sl:i:" + str(signal_length),
    ]
    if chains_summary is not None:
        s = chains_summary
        parts += [
            "cm:i:" + str(s.num_anchors),
            "nc:i:" + str(s.num_chains),
            "s1:f:" + fmt_float(s.s1),
            "s2:f:" + fmt_float(s.s2),
            "sm:f:" + fmt_float(s.sm),
            "ad:f:" + fmt_float(s.ad),
            "at:f:" + fmt_float(s.at),
            "aq:f:" + fmt_float(s.aq),
        ]
    return "\t".join(parts)


def batch_tags(
    mapping_time_ms: float,
    signal_length: int,
    chains_summary: "ChainsSummary | None",
) -> str:
    """Tag string for the non-streaming Map (sigmap.cc:403-415 mapped;
    sigmap.cc:517-524 unmapped: integer zeros)."""
    parts = [
        "mt:f:" + fmt_float(mapping_time_ms),
        "sl:i:" + str(signal_length),
    ]
    if chains_summary is not None:
        s = chains_summary
        parts += [
            "cm:i:" + str(s.num_anchors),
            "s1:f:" + fmt_float(s.s1),
            "s2:f:" + fmt_float(s.s2),
            "ad:f:" + fmt_float(s.ad),
            "at:f:" + fmt_float(s.at),
            "aq:f:" + fmt_float(s.aq),
        ]
    else:
        parts += ["cm:i:0", "s1:f:0", "s2:f:0"]
    return "\t".join(parts)


@dataclass
class ChainsSummary:
    """Best-chain statistics feeding the PAF tags (sigmap.cc:714-745).

    ad/at/aq are averages over the best chain's anchors; at/aq are *signed*
    sums of successive position differences divided by num_anchors."""

    num_anchors: int
    num_chains: int
    s1: float
    s2: float
    sm: float
    ad: float
    at: float
    aq: float


class PAFWriter:
    """Buffered writer that groups records per reference sequence, mirroring
    OutputMappingsInVector (sigmap.cc:197-215): records are emitted grouped by
    reference index; unmapped (mapq>60) records as '*' lines."""

    def __init__(self, path: str, ref_names: list[str], ref_lengths: list[int]):
        self.path = path
        self.ref_names = ref_names
        self.ref_lengths = ref_lengths
        self.per_ref: list[list[PAFRecord]] = [[] for _ in ref_names]

    def append(self, rec: PAFRecord) -> None:
        self.per_ref[rec.ref_index].append(rec)

    def finalize(self) -> int:
        n = 0
        with open(self.path, "w") as f:
            for ri, recs in enumerate(self.per_ref):
                for rec in recs:
                    if rec.is_mapped:
                        f.write(
                            mapped_line(
                                rec, self.ref_names[ri], self.ref_lengths[ri]
                            )
                        )
                    else:
                        f.write(unmapped_line(rec))
                    n += 1
        return n
