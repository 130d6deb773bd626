"""PAF record builders for the exact-engine rescue path.

Copies of ``sigmap_tpu/mapping/driver.py``'s ``chains_summary``,
``mapped_record`` and ``streaming_record`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from ..io.paf import ChainsSummary, PAFRecord, streaming_tags
from .chain import POSITIVE, Chain


def chains_summary(chains: list[Chain]) -> ChainsSummary:
    """Best-chain statistics (sigmap.cc:714-745)."""
    best = chains[0]
    a = best.anchors
    ad = float(a["dist"].sum()) / best.num_anchors
    at = float((a["target"][:-1] - a["target"][1:]).sum()) / best.num_anchors
    aq = float((a["query"][:-1] - a["query"][1:]).sum()) / best.num_anchors
    mean = sum(c.score for c in chains) / len(chains)
    return ChainsSummary(
        num_anchors=best.num_anchors, num_chains=len(chains),
        s1=best.score, s2=chains[1].score if len(chains) > 1 else 0.0,
        sm=mean, ad=ad, at=at, aq=aq,
    )


def mapped_record(index, rid, name, qlen, qstart, qend, chains, tags):
    best = chains[0]
    ref_len = index.ref_lengths[best.ref_index]
    if best.direction == POSITIVE:
        tstart = best.start_position
    else:
        tstart = ref_len + 1 - best.end_position
    return PAFRecord(
        read_id=rid, read_name=name, read_length=qlen,
        read_start=qstart, read_end=qend, ref_index=best.ref_index,
        fragment_start=int(tstart),
        fragment_length=int(best.end_position - best.start_position + 1),
        mapq=best.mapq, direction=1 if best.direction == POSITIVE else 0,
        tags=tags,
    )


def streaming_record(index, cfg, rid, name, sl, chunk_index_adj,
                     num_events, chains, mt_ms) -> PAFRecord:
    """Streaming output decision + record (sigmap.cc:694-866) from an
    already-adjusted chunk index (the loop-exhaustion decrement applied)."""
    m = cfg.mapping
    ci = chunk_index_adj + 1
    scale = 0.0
    if num_events > 0:
        scale = (ci * m.chunk_size / num_events) / (
            m.sample_rate / m.bp_per_sec
        )
    ch = chains or []
    mean = sum(c.score for c in ch) / len(ch) if ch else 0.0
    out_ok = (
        len(ch) >= 2
        and (
            ch[0].score / ch[1].score >= m.output_mapping_ratio
            or ch[0].score >= m.output_mapping_mean_ratio * mean
        )
    ) or (
        len(ch) == 1
        and ch[0].num_anchors >= m.output_mapping_min_num_anchors
    )
    if out_ok:
        summ = chains_summary(ch)
        tags = streaming_tags(mt_ms, ci, sl, summ)
        best = ch[0]
        return mapped_record(
            index, rid, name, sl,
            int(scale * best.anchors["query"][-1]),
            int(scale * best.anchors["query"][0]),
            ch, tags,
        )
    tags = streaming_tags(
        mt_ms, ci, sl, chains_summary(ch) if ch else None
    )
    return PAFRecord(
        read_id=rid, read_name=name, read_length=sl, read_start=0,
        read_end=0, ref_index=0, fragment_start=0, fragment_length=0,
        mapq=61, direction=0, tags=tags,
    )
