"""The exact engine: whole-read batch mode and streaming mode.

Counterpart of ``sigmap_tpu/mapping/driver.py`` (read its docstring for the
design): reads advance in lockstep wavefronts; event features
(``signal.events.batch_generate_features``, kernels B1 and B2: the exact
engine's features are turbo's) and the seed radius search
(``mapping.seeding``) run on ``device``; chunk assembly,
per-read chaining (``mapping.chain``, with the ``-t`` thread
pool), stop rules and PAF records stay on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import SigmapConfig
from ..index.build import SignalIndex
from ..io.paf import PAFRecord, batch_tags
from ..io.signals import ReadSignal
from ..signal.events import batch_generate_features
from .chain import generate_chains, make_anchors
from .records import chains_summary, mapped_record, streaming_record
from .seeding import (
    DeviceIndex, autotune_params, flatten_matches, pad_seeds, search_flat,
)


def _round_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def whole_read_rows(batch: list[ReadSignal], max_signal_len: int = 65536):
    """Batch mode's event rows: (chunks [B, C] f32, lengths [B] i32), each
    read's first max_signal_len samples, C a multiple of 4096."""
    C = _round_up(min(max(s.length for s in batch), max_signal_len), 4096)
    chunks = np.zeros((len(batch), C), np.float32)
    lengths = np.zeros(len(batch), np.int32)
    for i, s in enumerate(batch):
        L = min(s.length, C)
        chunks[i, :L] = s.pa[:L]
        lengths[i] = L
    return chunks, lengths


def streaming_rows(signals: list[ReadSignal], chunk_index, rows: int,
                   chunk_size: int):
    """Streaming mode's event rows for one wavefront: chunk chunk_index[i]
    of read i in row i of (chunks [rows, chunk_size] f32, lengths [rows]
    i32); rows past the reads stay empty."""
    chunks = np.zeros((rows, chunk_size), np.float32)
    lengths = np.zeros(rows, np.int32)
    for i, (s, c) in enumerate(zip(signals, chunk_index)):
        lo = c * chunk_size
        seg = s.pa[lo: min(lo + chunk_size, s.length)]
        chunks[i, : len(seg)] = seg
        lengths[i] = len(seg)
    return chunks, lengths


@dataclass
class _ReadState:
    index: int
    signal: ReadSignal
    chunk_index: int = 0
    num_events: int = 0
    chains: list = field(default_factory=list)
    mt_ms: float = 0.0


class Mapper:
    """Exact-engine mapper on an explicit ``device``."""

    def __init__(self, index: SignalIndex,
                 config: SigmapConfig = SigmapConfig(), *, device):
        self.device = torch.device(device)
        self.index = index
        self.cfg = config
        rt = config.runtime
        self.dev = DeviceIndex.from_host(
            index, radius=config.mapping.search_radius, device=self.device,
            seeds_per_tile=rt.seeds_per_tile, cap_per_seed=rt.cap_per_seed,
            surv_per_tile=rt.surv_per_tile,
            matches_per_tile=rt.matches_per_tile,
        )
        if rt.autotune_search:
            tuned = autotune_params(self.dev, max_cap=rt.cap_per_seed)
            self.dev = dataclasses.replace(self.dev, params=tuned)
        if index.win_group is None:
            index.derive_window_metadata()
        self.num_refs = len(index.ref_names)

    # ------------------------------------------------------------ common --

    def _chunk_features(self, chunks: np.ndarray, lengths: np.ndarray,
                        max_events: int, max_features: int):
        feats, counts = batch_generate_features(
            torch.from_numpy(chunks).to(self.device),
            torch.from_numpy(lengths).to(self.device),
            cfg=self.cfg.event, max_events=max_events,
            max_features=max_features,
            compress_delta=self.cfg.mapping.compress_delta,
        )
        return feats.cpu().numpy(), counts.cpu().numpy()

    def _seed_windows(self, feats_row: np.ndarray, count: int, step: int):
        """Seed positions s, 2s, ... <= n-dim (position 0 is never seeded,
        spatial_index.cc:349-356)."""
        dim = self.index.dim
        n = int(count)
        if n - dim < step:
            return np.zeros(0, np.int64), np.zeros((0, 8), np.float32)
        positions = np.arange(step, n - dim + 1, step, dtype=np.int64)
        Wf = np.lib.stride_tricks.sliding_window_view(feats_row[:n], dim)
        out = np.zeros((len(positions), 8), np.float32)
        out[:, :dim] = Wf[positions]
        return positions, out

    def _search(self, seed_windows: np.ndarray):
        """Flat radius search; returns (seed_ids, window_idx, dist)."""
        if len(seed_windows) == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        p = self.dev.params
        padded, valid, n_tiles = pad_seeds(seed_windows, p)
        out = search_flat(self.dev, padded, valid, n_tiles)
        sids, widx, dist, _, ovf = flatten_matches(out, p)
        if ovf.any():
            print(f"warning: seeding overflow flags {ovf}", file=sys.stderr)
        return sids, widx, dist

    def _anchors_by_group(self, widx, dist, qpos):
        """Decode window indices into per-(ref, strand) anchor arrays."""
        group = self.index.win_group[widx]
        tpos = self.index.win_pos[widx]
        out = {}
        for g in np.unique(group):
            sel = group == g
            out[(int(g) // 2, int(g) % 2)] = make_anchors(
                tpos[sel], qpos[sel], dist[sel]
            )
        return out

    def _round_seeds(self, feats, counts, n: int, step: int, offsets):
        """Seeds of rows 0..n-1 with more than min_feature_length features
        -> (windows, qpos, read of each seed) flat, or None."""
        m = self.cfg.mapping
        rows, qpos, read = [], [], []
        for i in range(n):
            if counts[i] > m.min_feature_length:
                pos, wins = self._seed_windows(feats[i], counts[i], step)
                rows.append(wins)
                qpos.append(pos + offsets[i])
                read.append(np.full(len(pos), i, np.int64))
        if not rows:
            return None
        return np.concatenate(rows), np.concatenate(qpos), np.concatenate(read)

    @staticmethod
    def _split_matches(seeds, matches, n: int):
        """This pass's matches -> for each row i < n, (widx, dist, qpos) of
        its matches in compaction order.  One stable sort by read gives what
        the reference's per-row mask ``all_read[sids] == i`` selects, in one
        pass over the matches instead of n."""
        if seeds is None:
            return [None] * n
        _wins, all_qpos, all_read = seeds
        sids, widx, dist = matches
        read = all_read[sids]
        order = np.argsort(read, kind="stable")
        bounds = np.searchsorted(read[order], np.arange(n + 1))
        widx, dist, qpos = widx[order], dist[order], all_qpos[sids[order]]
        return [(widx[a:b], dist[a:b], qpos[a:b])
                for a, b in zip(bounds[:-1], bounds[1:])]

    def _chains(self, part, prev):
        """Chains of one row from its matches (a _split_matches entry),
        extending prev."""
        m = self.cfg.mapping
        groups = ({} if part is None or len(part[0]) == 0
                  else self._anchors_by_group(*part))
        return generate_chains(groups, prev, self.num_refs, m.search_radius,
                               self.index.dim, self.cfg.chain)

    # --------------------------------------------------------- batch mode --

    def map_reads(self, signals: list[ReadSignal],
                  max_signal_len: int = 65536) -> list[PAFRecord]:
        """Whole-read mapping (Sigmap::Map, sigmap.cc:243-547): one event
        pass over the full read, seeding step 1, unconditional best-chain
        output.  Reads with <= 50 features produce no record (quirk:
        sigmap.cc:355 has no else branch)."""
        m = self.cfg.mapping
        records: list[PAFRecord] = []
        B = self.cfg.runtime.read_batch
        for base in range(0, len(signals), B):
            batch = signals[base: base + B]
            t0 = time.perf_counter()
            chunks, lengths = whole_read_rows(batch, max_signal_len)
            C = chunks.shape[1]
            feats, counts = self._chunk_features(
                chunks, lengths, max_events=max(1024, C // 4),
                max_features=max(1024, C // 4),
            )
            seeds = self._round_seeds(feats, counts, len(batch), 1,
                                      np.zeros(len(batch), np.int64))
            matches = self._search(seeds[0]) if seeds is not None else None
            elapsed_ms = (time.perf_counter() - t0) * 1000 / len(batch)
            parts = self._split_matches(seeds, matches, len(batch))
            for i, s in enumerate(batch):
                if counts[i] <= m.min_feature_length:
                    continue  # silently dropped (sigmap.cc:355)
                chains = self._chains(parts[i], [])
                nfeat = int(counts[i])
                if chains:
                    best = chains[0]
                    tags = batch_tags(elapsed_ms, s.length,
                                      chains_summary(chains))
                    records.append(mapped_record(
                        self.index, base + i, s.read_id, nfeat,
                        int(best.anchors["query"][-1]),
                        int(best.anchors["query"][0]), chains, tags,
                    ))
                else:
                    records.append(PAFRecord(
                        read_id=base + i, read_name=s.read_id,
                        read_length=nfeat, read_start=0, read_end=0,
                        ref_index=0, fragment_start=0, fragment_length=0,
                        mapq=61, direction=0,
                        tags=batch_tags(elapsed_ms, s.length, None),
                    ))
        return records

    # ----------------------------------------------------- streaming mode --

    def streaming_map(self, signals: list[ReadSignal]) -> list[PAFRecord]:
        """Streaming mapping (Sigmap::StreamingMap, sigmap.cc:549-880):
        4000-sample chunks, carried chains, early-stop + output gating."""
        m = self.cfg.mapping
        rt = self.cfg.runtime
        states = [_ReadState(i, s) for i, s in enumerate(signals)]
        pending = list(reversed(states))
        active: list[_ReadState] = []
        records: dict[int, PAFRecord] = {}
        B = rt.read_batch
        Cs = m.chunk_size

        while pending or active:
            while len(active) < B and pending:
                st = pending.pop()
                if st.signal.length // Cs == 0 or m.max_num_chunks == 0:
                    # no full chunk ever processed -> immediate unmapped
                    self._finish_streaming(st, records)
                    continue
                active.append(st)
            if not active:
                break
            t0 = time.perf_counter()
            chunks, lengths = streaming_rows(
                [st.signal for st in active],
                [st.chunk_index for st in active], B, Cs)
            feats, counts = self._chunk_features(
                chunks, lengths, rt.max_events, rt.max_features
            )
            seeds = self._round_seeds(
                feats, counts, len(active), m.step_size,
                np.array([st.num_events for st in active], np.int64))
            matches = self._search(seeds[0]) if seeds is not None else None
            round_ms = (time.perf_counter() - t0) * 1000 / max(1, len(active))
            parts = self._split_matches(seeds, matches, len(active))

            # per-read chaining is independent across reads; -t fans it over
            # a host thread pool (the native DP releases the GIL), the
            # analogue of the reference's OpenMP taskloop (sigmap.cc:618-631)
            def chain_one(i_st):
                i, st = i_st
                if counts[i] <= m.min_feature_length:
                    return None
                return self._chains(parts[i], st.chains)

            nthreads = rt.num_threads
            if nthreads > 1 and len(active) > 1:
                with ThreadPoolExecutor(nthreads) as ex:
                    new_chains = list(ex.map(chain_one, enumerate(active)))
            else:
                new_chains = [chain_one(x) for x in enumerate(active)]

            still_active: list[_ReadState] = []
            for i, st in enumerate(active):
                st.mt_ms += round_ms
                stop = False
                if new_chains[i] is not None:
                    st.chains = new_chains[i]
                    st.num_events += int(counts[i])
                    ch = st.chains
                    if len(ch) >= 2:
                        if ch[0].score / ch[1].score >= m.stop_mapping_ratio:
                            stop = True
                        else:
                            mean = sum(c.score for c in ch) / len(ch)
                            if ch[0].score >= m.stop_mapping_mean_ratio * mean:
                                stop = True
                    elif (
                        len(ch) == 1
                        and ch[0].num_anchors >= m.stop_mapping_min_num_anchors
                    ):
                        stop = True
                # the reference's `break` on stop skips the loop increment,
                # so chunk_index stays at the stopped chunk (sigmap.cc:647-689)
                if stop:
                    self._finish_streaming(st, records)
                    continue
                st.chunk_index += 1
                exhausted = (
                    st.chunk_index >= st.signal.length // Cs
                    or st.chunk_index >= m.max_num_chunks
                )
                if exhausted:
                    self._finish_streaming(st, records)
                else:
                    still_active.append(st)
            active = still_active

        return [records[i] for i in range(len(signals)) if i in records]

    def _finish_streaming(self, st: _ReadState, records: dict) -> None:
        """Decision + emission (sigmap.cc:690-866)."""
        m = self.cfg.mapping
        chunk_index = st.chunk_index
        # loop-exhaustion adjustment (sigmap.cc:690-693)
        num_chunks = st.signal.length // m.chunk_size
        if chunk_index > 0 and (
            chunk_index == num_chunks or chunk_index == m.max_num_chunks
        ):
            chunk_index -= 1
        records[st.index] = streaming_record(
            self.index, self.cfg, st.index, st.signal.read_id,
            st.signal.length, chunk_index, st.num_events, st.chains,
            st.mt_ms,
        )
