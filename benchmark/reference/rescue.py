"""The rescue, plain: the exact engine that re-maps a read whose rounds end
unmapped after a capacity overflow.

The semantics of the port's ``oracle.py:Oracle.streaming_read`` with its
native core (``csrc/core.cc``): per 4000-sample chunk of the read's pA,
the event features (``sig_features``: centered two-window t-statistics,
the dual peak detector, event means summed in order, a float64 z-score and
the delta collapse), seeds every ``step`` features, every index window
with a squared distance below the radius (``sig_kd_radius_batch``: the
distance summed dimension by dimension in f32, strict ``<``), the chaining
DP (``sig_chain_scores``) and ``mapping/chain.py``'s selection, traceback
and MAPQ, with the reference's stop rules between chunks.

Written in numpy and torch, not copied from C++: the features are
vectorised over chunk rows and positions, the radius search probes the
reference index's 6-D cell grid on the device, and the DP runs blocks of
anchors to a fixed point (``chain_scores``).  A query with more matches
than the engine's cap keeps the ones the k-d tree meets first, an order
this search cannot know: such a read is reported as undecided, not
compared.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from .index import CELL_OFFSET, CELL_RADIX
from .records import ChainsSummary, Record, streaming_tags

FLT_MAX = np.float32(3.4028235e38)
FLT_MIN = np.float32(1.17549435e-38)
POSITIVE, NEGATIVE = 1, 0


class Undecided(Exception):
    """The read's result depends on an order the reference cannot know."""


# ---- event features (core.cc:sig_features) ---------------------------------

def tstat_rows(x: np.ndarray, n: np.ndarray, w: int) -> np.ndarray:
    """core.cc:tstat_centered for each row of x [R, C] (f32) of length n[r]:
    window sums added in order, centered variance, 0 outside [w, n - w]."""
    R, C = x.shape
    out = np.zeros((R, C), np.float32)
    if w < 2:
        return out
    i = np.arange(w, C - w + 1)
    if len(i) == 0:
        return out
    s1 = x[:, i - w].copy()
    s2 = x[:, i].copy()
    for k in range(1, w):
        s1 += x[:, i - w + k]
        s2 += x[:, i + k]
    wf = np.float32(w)
    m1, m2 = s1 / wf, s2 / wf
    v = np.zeros_like(s1)
    for k in range(w):
        d1 = x[:, i - w + k] - m1
        d2 = x[:, i + k] - m2
        v += d1 * d1 + d2 * d2
    v /= wf
    v = np.maximum(v, FLT_MIN)
    t = np.abs(m2 - m1) / np.sqrt(v / wf)
    ok = (i[None, :] <= (n[:, None] - w)) & (n[:, None] >= 2 * w)
    out[:, i] = np.where(ok, t, np.float32(0))
    return out


def detect_peaks_rows(t1, t2, n, w1, w2, th1, th2, ph):
    """core.cc:detect_peaks for each row (the short detector first each
    step; its crossing masks and resets the long one).  Returns a list of
    peak position arrays."""
    R, C = t1.shape
    th = (np.float32(th1), np.float32(th2))
    wl = (w1, w2)
    ph = np.float32(ph)
    masked = [np.zeros(R, np.int64), np.zeros(R, np.int64)]
    pos = [np.full(R, -1, np.int64), np.full(R, -1, np.int64)]
    val = [np.full(R, FLT_MAX, np.float32), np.full(R, FLT_MAX, np.float32)]
    valid = [np.zeros(R, bool), np.zeros(R, bool)]
    peaks = [[] for _ in range(R)]
    ts = (t1, t2)
    for i in range(C):
        live = i < n
        for k in (0, 1):
            act = live & ~(masked[k] >= i)
            if not act.any():
                continue
            v = ts[k][:, i]
            undef = act & (pos[k] == -1)
            lower = undef & (v < val[k])
            rise = undef & ~(v < val[k]) & ((v - val[k]) > ph)
            val[k] = np.where(lower | rise, v, val[k])
            pos[k] = np.where(rise, i, pos[k])
            dfn = act & ~undef
            up = dfn & (v > val[k])
            val[k] = np.where(up, v, val[k])
            pos[k] = np.where(up, i, pos[k])
            if k == 0:
                dom = dfn & (val[0] > th[0])
                masked[1] = np.where(dom, pos[0] + wl[0], masked[1])
                pos[1] = np.where(dom, -1, pos[1])
                val[1] = np.where(dom, FLT_MAX, val[1])
                valid[1] = np.where(dom, False, valid[1])
            valid[k] = valid[k] | (dfn & ((val[k] - v) > ph)
                                   & (val[k] > th[k]))
            emit = dfn & valid[k] & ((i - pos[k]) > wl[k] // 2)
            for r in np.flatnonzero(emit):
                peaks[r].append(pos[k][r])
            pos[k] = np.where(emit, -1, pos[k])
            val[k] = np.where(emit, v, val[k])
            valid[k] = np.where(emit, False, valid[k])
    return [np.array(p, np.int64) for p in peaks]


def features_rows(chunks, cfg, compress_delta: float):
    """core.cc:sig_features of each chunk (a list of f32 arrays): the
    compressed feature signal of each."""
    e = cfg
    n = np.array([len(c) for c in chunks])
    C = int(n.max()) if len(n) else 0
    x = np.zeros((len(chunks), C), np.float32)
    for r, c in enumerate(chunks):
        x[r, :len(c)] = c
    t1 = tstat_rows(x, n, e.window_length1)
    t2 = tstat_rows(x, n, e.window_length2)
    peaks = detect_peaks_rows(t1, t2, n, e.window_length1, e.window_length2,
                              e.threshold1, e.threshold2, e.peak_height)
    delta = np.float32(compress_delta)
    out = []
    for r, p in enumerate(peaks):
        L = int(n[r])
        if L <= 0:
            out.append(np.zeros(0, np.float32))
            continue
        bounds = [0]
        if len(p) == 1:
            bounds.append(int(p[0]))
        bounds += [int(v) for v in p[:-1]]
        bounds.append(L)
        a = np.array(bounds[:-1], np.int64)
        b = np.array(bounds[1:], np.int64)
        lens = b - a
        s = np.zeros(len(a), np.float32)
        for k in range(int(lens.max())):
            live = lens > k
            s[live] += x[r, a[live] + k]
        means = s / lens.astype(np.float32)
        ne = len(means)
        m64 = means.astype(np.float64)
        mean = np.cumsum(m64)[-1] / ne
        sd = np.sqrt(np.cumsum((m64 - mean) * (m64 - mean))[-1]
                     / (ne - 1 if ne > 1 else 1))
        z = ((m64 - mean) / sd).astype(np.float32)
        keep = []
        last = np.float32(0)
        for j in range(ne):
            if j == 0 or np.abs(z[j] - last) > delta:
                keep.append(z[j])
                last = z[j]
        out.append(np.array(keep, np.float32))
    return out


# ---- radius search (core.cc:sig_kd_radius_batch) ----------------------------

class RadiusSearch:
    """Every window of the reference index within the radius of a query,
    by the index's 6-D cell grid (cell width sqrt(radius): a match lies
    within one cell of the query in each dimension) on ``device``."""

    def __init__(self, idx, device):
        self.idx = idx
        self.dev = torch.device(device)
        self.vals = torch.from_numpy(idx.values).to(self.dev)
        self.keys = torch.from_numpy(idx.cell_keys).to(self.dev)
        self.starts = torch.from_numpy(idx.cell_starts).to(self.dev)
        self.perm = torch.from_numpy(idx.perm.astype(np.int64)).to(self.dev)
        bd = idx.bucket_dims
        self.offs = torch.tensor(list(itertools.product((-1, 0, 1),
                                                        repeat=bd)),
                                 dtype=torch.int64, device=self.dev)

    def search(self, queries: np.ndarray, radius: float, cap: int,
               block: int = 64):
        """queries [nq, dim] f32 -> (window ids, f32 d^2, counts [nq]);
        raises Undecided if a query has more than ``cap`` matches."""
        idx = self.idx
        dim, bd = idx.dim, idx.bucket_dims
        r2 = torch.tensor(radius, dtype=torch.float32, device=self.dev)
        cw = np.float32(idx.cell_width)
        out_i, out_d, counts = [], [], []
        for q0 in range(0, len(queries), block):
            q = torch.from_numpy(queries[q0: q0 + block]).to(self.dev)
            nq = q.shape[0]
            # the index's own cell coordinates (build: floor(v / cw) + 17,
            # clipped), computed the same way for the query
            qc = torch.floor(q[:, :bd] / torch.full_like(q[:, :bd], cw))
            qc = torch.clamp(qc.to(torch.int64) + CELL_OFFSET, 0,
                             CELL_RADIX - 1)
            pc = torch.clamp(qc[:, None, :] + self.offs[None], 0,
                             CELL_RADIX - 1)                 # [nq, P, bd]
            key = torch.zeros(pc.shape[:2], dtype=torch.int64,
                              device=self.dev)
            for d in range(bd):
                key = key * CELL_RADIX + pc[:, :, d]
            # clipping can repeat a probe: keep each cell once per query
            key = torch.sort(key, dim=1).values
            dup = torch.zeros_like(key, dtype=torch.bool)
            dup[:, 1:] = key[:, 1:] == key[:, :-1]
            pos = torch.searchsorted(self.keys, key)
            pos_c = torch.clamp(pos, max=len(self.keys) - 1)
            hit = (self.keys[pos_c] == key) & ~dup
            lo = torch.where(hit, self.starts[pos_c], 0)
            hi = torch.where(hit, self.starts[pos_c + 1], 0)
            n = (hi - lo).reshape(-1)
            total = int(n.sum())
            qid = torch.repeat_interleave(
                torch.arange(nq, device=self.dev).repeat_interleave(
                    key.shape[1]), n)
            first = torch.repeat_interleave(lo.reshape(-1), n)
            within = torch.arange(total, device=self.dev) - \
                torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
            w = self.perm[first + within]
            acc = torch.zeros(total, dtype=torch.float32, device=self.dev)
            for d in range(dim):
                diff = q[qid, d] - self.vals[w + d]
                acc = acc + diff * diff
            ok = acc < r2
            qid, w, acc = qid[ok], w[ok], acc[ok]
            c = torch.bincount(qid, minlength=nq)
            if int(c.max()) > cap if nq else False:
                raise Undecided(f"a query has {int(c.max())} matches, "
                                f"over the engine's cap of {cap}")
            order = torch.argsort(qid * (1 << 40) + w)
            out_i.append(w[order].cpu().numpy())
            out_d.append(acc[order].cpu().numpy())
            counts.append(c.cpu().numpy())
        if not out_i:
            return (np.zeros(0, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        return (np.concatenate(out_i), np.concatenate(out_d),
                np.concatenate(counts))


# ---- chaining (core.cc:sig_chain_scores, mapping/chain.py) ------------------

ANCHOR_DTYPE = np.dtype(
    [("target", np.int64), ("query", np.int64), ("dist", np.float32)])


def chain_scores(tp, qp, dd, radius: float, dim: int, cfg,
                 block: int = 64):
    """core.cc:sig_chain_scores over one sorted anchor group: for anchor i,
    predecessors j = i-1 down to the band's start or the first more than
    max_target_gap_length behind, skipping same-query or same-target
    anchors and those of lower query, a candidate score where the gap
    gates pass, a strict improvement counting a skip down and anything
    else a skip up, stopping past max_num_skips.

    Anchors are taken in blocks: within a block every anchor's scan is
    recomputed from the scores so far until no score changes; anchors of
    earlier blocks are final, so the fixed point is the sequential
    result."""
    n = len(tp)
    tp = tp.astype(np.int64)
    qp = qp.astype(np.int64)
    coef = (np.float32(1.0) - np.float32(0.2) * dd.astype(np.float32)
            / np.float32(radius)).astype(np.float32)
    init = (coef * np.float32(dim)).astype(np.float32)
    scores = init.copy()
    pred = np.arange(n, dtype=np.int64)
    if n == 0:
        return scores, pred
    lo_t = np.searchsorted(tp, tp - cfg.max_target_gap_length, side="left")
    band = np.maximum(np.arange(n) - cfg.chaining_band_length, 0)
    start = np.maximum(lo_t, band)
    for b0 in range(0, n, block):
        rows = np.arange(b0, min(n, b0 + block))
        W = int((rows - start[rows]).max())
        if W <= 0:
            continue
        k = np.arange(W)
        j = rows[:, None] - 1 - k[None, :]                     # [r, W]
        inwin = j >= start[rows][:, None]
        jc = np.where(inwin, j, 0)
        tdiff = tp[rows][:, None] - tp[jc]
        qdiff = qp[rows][:, None] - qp[jc]
        counted = (inwin & (qp[jc] != qp[rows][:, None])
                   & (tp[jc] != tp[rows][:, None]) & (qdiff >= 0))
        c = coef[rows][:, None]
        match_dim = (np.minimum(np.minimum(tdiff, qdiff), dim)
                     .astype(np.float32) * c).astype(np.float32)
        gap = np.abs(tdiff - qdiff)
        gs = np.where(tdiff > 0,
                      qdiff.astype(np.float32)
                      / np.where(tdiff > 0, tdiff, 1).astype(np.float32),
                      np.float32(1.0)).astype(np.float32)
        gate = ((gap < cfg.max_gap_length) & (gs < np.float32(5.0))
                & (gs > np.float32(0.75)))
        for _ in range(len(rows) + 1):
            cand = np.where(gate, scores[jc] + match_dim,
                            np.float32(0)).astype(np.float32)
            cand = np.where(counted, cand, -np.inf).astype(np.float32)
            run = np.maximum.accumulate(
                np.concatenate([init[rows][:, None], cand], axis=1),
                axis=1)
            improve = counted & (cand > run[:, :-1])
            step = np.where(improve, -1, np.where(counted, 1, 0))
            skips = np.cumsum(step, axis=1)
            stop = counted & ~improve & (skips > cfg.max_num_skips)
            first_stop = np.where(stop.any(axis=1), stop.argmax(axis=1), W)
            live = improve & (k[None, :] < first_stop[:, None])
            any_imp = live.any(axis=1)
            last = W - 1 - np.argmax(live[:, ::-1], axis=1)
            new_s = np.where(any_imp, cand[np.arange(len(rows)), last],
                             init[rows]).astype(np.float32)
            new_p = np.where(any_imp, j[np.arange(len(rows)), last], rows)
            if np.array_equal(new_s, scores[rows]) and \
                    np.array_equal(new_p, pred[rows]):
                break
            scores[rows] = new_s
            pred[rows] = new_p
    return scores, pred


@dataclass
class Chain:
    score: float
    ref_index: int
    start_position: int
    end_position: int
    num_anchors: int
    mapq: int
    direction: int
    anchors: np.ndarray

    def sort_key(self):
        return (self.score, self.num_anchors, self.direction, self.ref_index,
                self.start_position, self.end_position)


def make_anchors(target, query, dist):
    a = np.empty(len(target), ANCHOR_DTYPE)
    a["target"], a["query"], a["dist"] = target, query, dist
    return a


def generate_chains(new_anchors, prev_chains, num_refs, radius, dim, cfg):
    """mapping/chain.py:generate_chains with ``chain_scores`` above."""
    groups: dict = {}
    for ch in prev_chains:
        sb = 0 if ch.direction == POSITIVE else 1
        groups.setdefault((ch.ref_index, sb), []).append(ch.anchors)
    for key, arr in new_anchors.items():
        if len(arr):
            groups.setdefault(key, []).append(arr)
    chains: list = []
    max_score = 0.0
    for ref_idx in range(num_refs):
        for sb in (0, 1):
            parts = groups.get((ref_idx, sb))
            if not parts:
                continue
            anchors = np.concatenate(parts)
            order = np.lexsort((anchors["dist"], anchors["query"],
                                anchors["target"]))
            anchors = anchors[order]
            n = len(anchors)
            scores, pred = chain_scores(anchors["target"], anchors["query"],
                                        anchors["dist"], radius, dim, cfg)
            runmax = np.maximum.accumulate(
                np.maximum(scores, np.float32(max_score)))
            sel = (scores >= cfg.min_chaining_score) & (scores > runmax / 2)
            max_score = float(runmax[-1]) if n else max_score
            cand_idx = np.nonzero(sel)[0]
            if len(cand_idx) == 0:
                continue
            order2 = sorted(cand_idx.tolist(), key=lambda i: (-scores[i], -i))
            used = np.zeros(n, bool)
            direction = POSITIVE if sb == 0 else NEGATIVE
            for end_i in order2[: cfg.num_best_chains]:
                _traceback(anchors, scores, pred, used, end_i, ref_idx,
                           direction, cfg.min_num_anchors, chains)
                if scores[end_i] < max_score / 2:
                    break
    if not chains:
        return []
    primary = _primary_chains(chains)
    if len(primary) == 1:
        primary[0].mapq = 60
    else:
        mapq = int(40 * (1 - primary[1].score / primary[0].score))
        primary[0].mapq = max(0, min(60, mapq))
    return primary


def _traceback(anchors, scores, pred, used, end_i, ref_idx, direction,
               min_num_anchors, chains):
    if used[end_i]:
        return
    out = [end_i]
    stopped_at_used = False
    i = end_i
    if pred[i] != i and used[pred[i]]:
        stopped_at_used = True
    used[i] = True
    while pred[i] != i and not used[pred[i]]:
        i = pred[i]
        out.append(i)
        if pred[i] != i and used[pred[i]]:
            stopped_at_used = True
        used[i] = True
    if len(out) < min_num_anchors:
        return
    score = float(scores[end_i])
    if stopped_at_used:
        score -= float(scores[pred[i]])
    chains.append(Chain(score, ref_idx, int(anchors["target"][i]),
                        int(anchors["target"][end_i]), len(out), 0,
                        direction, anchors[np.array(out)]))


def _primary_chains(chains):
    chains = sorted(chains, key=lambda c: c.sort_key(), reverse=True)
    primary = [chains[0]]
    for c in chains[1:]:
        if c.score < primary[-1].score / 3:
            break
        if all(c.ref_index != p.ref_index
               or max(c.start_position, p.start_position)
               > min(c.end_position, p.end_position) for p in primary):
            primary.append(c)
    return primary


# ---- one read (oracle.py:streaming_read, mapping/records.py) ---------------

def streaming_read(pa: np.ndarray, idx, search: RadiusSearch, cfg):
    """The exact engine's streaming path on one read: (chunk index after
    the loop-exhaustion adjustment, events, chains)."""
    m = cfg.mapping
    L = len(pa)
    num_chunks = L // m.chunk_size
    last = min(num_chunks, m.max_num_chunks)
    feats_all = features_rows(
        [pa[c * m.chunk_size: min((c + 1) * m.chunk_size, L)]
         for c in range(last)], cfg.event, m.compress_delta)
    dim = idx.dim
    chains: list = []
    num_events = 0
    chunk_index = 0
    stopped = False
    while chunk_index < last:
        feats = feats_all[chunk_index]
        if len(feats) > m.min_feature_length:
            n = len(feats)
            positions = (np.arange(m.step_size, n - dim + 1, m.step_size)
                         if n - dim >= m.step_size else np.zeros(0, np.int64))
            groups = {}
            if len(positions):
                Wf = np.lib.stride_tricks.sliding_window_view(feats, dim)
                queries = np.ascontiguousarray(Wf[positions], np.float32)
                fi, fd, fc = search.search(queries, m.search_radius,
                                           cfg.chain.num_nearest_points)
                qpos = np.repeat(positions + num_events, fc)
                group = idx.win_group[fi]
                tpos = idx.win_pos[fi]
                for g in np.unique(group):
                    sel = group == g
                    groups[(int(g) // 2, int(g) % 2)] = make_anchors(
                        tpos[sel], qpos[sel], fd[sel])
            chains = generate_chains(groups, chains, len(idx.ref_lengths),
                                     m.search_radius, dim, cfg.chain)
            num_events += n
            if len(chains) >= 2:
                if chains[0].score / chains[1].score >= m.stop_mapping_ratio:
                    stopped = True
                else:
                    mean = sum(c.score for c in chains) / len(chains)
                    if chains[0].score >= m.stop_mapping_mean_ratio * mean:
                        stopped = True
            elif (len(chains) == 1 and chains[0].num_anchors
                  >= m.stop_mapping_min_num_anchors):
                stopped = True
        if stopped:
            break
        chunk_index += 1
    if chunk_index > 0 and (chunk_index == num_chunks
                            or chunk_index == m.max_num_chunks):
        chunk_index -= 1
    return chunk_index, num_events, chains


def chains_summary(chains) -> ChainsSummary:
    best = chains[0]
    a = best.anchors
    return ChainsSummary(
        num_anchors=best.num_anchors, num_chains=len(chains), s1=best.score,
        s2=chains[1].score if len(chains) > 1 else 0.0,
        sm=sum(c.score for c in chains) / len(chains),
        ad=float(a["dist"].sum()) / best.num_anchors,
        at=float((a["target"][:-1] - a["target"][1:]).sum())
        / best.num_anchors,
        aq=float((a["query"][:-1] - a["query"][1:]).sum())
        / best.num_anchors)


def rescue_record(name: str, pa: np.ndarray, idx, search, cfg) -> Record:
    """mapping/records.py:streaming_record of the exact engine's result."""
    m = cfg.mapping
    chunk_index, num_events, ch = streaming_read(pa, idx, search, cfg)
    ci = chunk_index + 1
    sl = len(pa)
    scale = 0.0
    if num_events > 0:
        scale = (ci * m.chunk_size / num_events) / (
            m.sample_rate / m.bp_per_sec)
    mean = sum(c.score for c in ch) / len(ch) if ch else 0.0
    out_ok = (len(ch) >= 2 and (
        ch[0].score / ch[1].score >= m.output_mapping_ratio
        or ch[0].score >= m.output_mapping_mean_ratio * mean)) or (
        len(ch) == 1 and ch[0].num_anchors >= m.output_mapping_min_num_anchors)
    if out_ok:
        best = ch[0]
        ref_len = idx.ref_lengths[best.ref_index]
        tstart = (best.start_position if best.direction == POSITIVE
                  else ref_len + 1 - best.end_position)
        return Record(name, sl, int(scale * best.anchors["query"][-1]),
                      int(scale * best.anchors["query"][0]), best.ref_index,
                      int(tstart),
                      int(best.end_position - best.start_position + 1),
                      best.mapq, 1 if best.direction == POSITIVE else 0,
                      streaming_tags(ci, sl, chains_summary(ch)))
    return Record(name, sl, 0, 0, 0, 0, 0, 61, 0,
                  streaming_tags(ci, sl, chains_summary(ch) if ch else None))
