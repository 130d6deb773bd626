"""Records as the check compares them: every field of the port's
``PAFRecord`` but ``read_id`` (a position within a call) and the ``mt:``
tag (a time).  The tag layout is a frozen copy of ``io/paf.py``'s
``streaming_tags`` and ``mapping/records.py``'s ``chains_summary``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


class Record(NamedTuple):
    read_name: str
    read_length: int
    read_start: int
    read_end: int
    ref_index: int
    fragment_start: int
    fragment_length: int
    mapq: int
    direction: int
    tags: str               # streaming tags without mt:


def from_paf(rec) -> Record:
    """The program's PAFRecord as the check compares it."""
    tags = "\t".join(t for t in rec.tags.split("\t")
                     if not t.startswith("mt:"))
    return Record(rec.read_name, rec.read_length, rec.read_start,
                  rec.read_end, rec.ref_index, rec.fragment_start,
                  rec.fragment_length, rec.mapq, rec.direction, tags)


@dataclass
class ChainsSummary:
    num_anchors: int
    num_chains: int
    s1: float
    s2: float
    sm: float
    ad: float
    at: float
    aq: float


def fmt_float(x: float) -> str:
    """C++ std::to_string(float/double): printf %f, 6 decimals."""
    return f"{float(x):.6f}"


def streaming_tags(num_chunks: int, signal_length: int,
                   s: "ChainsSummary | None") -> str:
    """StreamingMap's tags (sigmap.cc:731-745, 825-858) without mt:."""
    parts = ["ci:i:" + str(num_chunks), "sl:i:" + str(signal_length)]
    if s is not None:
        parts += [
            "cm:i:" + str(s.num_anchors), "nc:i:" + str(s.num_chains),
            "s1:f:" + fmt_float(s.s1), "s2:f:" + fmt_float(s.s2),
            "sm:f:" + fmt_float(s.sm), "ad:f:" + fmt_float(s.ad),
            "at:f:" + fmt_float(s.at), "aq:f:" + fmt_float(s.aq),
        ]
    return "\t".join(parts)
