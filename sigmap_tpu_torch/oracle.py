"""Single-read host pipeline: native events + exact k-d tree + host chains.

JAX-free counterpart of ``sigmap_tpu/oracle.py`` with the same method
names.  It runs on the native core only (event features, k-d tree radius
search) plus ``mapping.chain``; there is no numpy events
fallback, so it raises if the native core is missing.  The turbo mapper
uses it to re-map reads that end unmapped after a capacity overflow.
"""

from __future__ import annotations

import numpy as np

from . import _build, native
from .config import SigmapConfig
from .index.build import SignalIndex
from .mapping.chain import Chain, generate_chains, make_anchors


class Oracle:
    def __init__(self, index: SignalIndex,
                 config: SigmapConfig = SigmapConfig()):
        _build.native()
        self.index = index
        self.cfg = config
        if index.win_group is None:
            index.derive_window_metadata()
        from .mapping.spans import setup_span

        with setup_span("setup.tree") as sp:
            self.tree = native.KdTree(index.values, index.dim,
                                      index.max_leaf)
        self.build_span = sp
        self.num_refs = len(index.ref_names)

    def features_for(self, pa: np.ndarray) -> np.ndarray:
        e = self.cfg.event
        out = native.features(
            pa, e.window_length1, e.window_length2, e.threshold1,
            e.threshold2, e.peak_height, self.cfg.mapping.compress_delta,
        )
        if out is None:
            raise RuntimeError("native core unavailable")
        return out[0]

    def seeds_for(self, feats: np.ndarray, step: int):
        dim = self.index.dim
        n = len(feats)
        if n - dim < step:
            return np.zeros(0, np.int64)
        return np.arange(step, n - dim + 1, step, dtype=np.int64)

    def chains_for_chunk(
        self, feats: np.ndarray, step: int, offset: int, prev: list[Chain],
        search=None,
    ) -> list[Chain]:
        """One chunk's chains.  ``search`` answers the chunk's radius query
        as ``KdTree.radius_batch`` does (the k-d tree when None)."""
        m = self.cfg.mapping
        dim = self.index.dim
        positions = self.seeds_for(feats, step)
        groups: dict = {}
        if len(positions):
            Wf = np.lib.stride_tricks.sliding_window_view(feats, dim)
            queries = Wf[positions].astype(np.float32)
            fi, fd, fc = (search or self.tree.radius_batch)(
                queries, m.search_radius,
                per_cap=self.cfg.chain.num_nearest_points,
            )
            qpos_per_match = np.repeat(positions + offset, fc)
            group = self.index.win_group[fi]
            tpos = self.index.win_pos[fi]
            for g in np.unique(group):
                sel = group == g
                groups[(int(g) // 2, int(g) % 2)] = make_anchors(
                    tpos[sel], qpos_per_match[sel], fd[sel]
                )
        return generate_chains(
            groups, prev, self.num_refs, m.search_radius, dim, self.cfg.chain
        )

    def map_read(self, pa: np.ndarray):
        """Whole-read Map() path; returns (n_features, chains)."""
        feats = self.features_for(pa)
        if len(feats) <= self.cfg.mapping.min_feature_length:
            return len(feats), None
        return len(feats), self.chains_for_chunk(feats, 1, 0, [])

    def streaming_read(self, pa: np.ndarray, search=None):
        """Streaming path; returns (chunk_index_adj, num_events, chains,
        stopped_early).  ``search``: as chains_for_chunk's."""
        m = self.cfg.mapping
        L = len(pa)
        num_chunks = L // m.chunk_size
        chains: list[Chain] = []
        num_events = 0
        chunk_index = 0
        stopped = False
        while chunk_index < num_chunks and chunk_index < m.max_num_chunks:
            lo = chunk_index * m.chunk_size
            hi = min(lo + m.chunk_size, L)
            feats = self.features_for(pa[lo:hi])
            if len(feats) > m.min_feature_length:
                chains = self.chains_for_chunk(
                    feats, m.step_size, num_events, chains, search
                )
                num_events += len(feats)
                if len(chains) >= 2:
                    if chains[0].score / chains[1].score >= m.stop_mapping_ratio:
                        stopped = True
                    else:
                        mean = sum(c.score for c in chains) / len(chains)
                        if chains[0].score >= m.stop_mapping_mean_ratio * mean:
                            stopped = True
                elif (
                    len(chains) == 1
                    and chains[0].num_anchors >= m.stop_mapping_min_num_anchors
                ):
                    stopped = True
            if stopped:
                break  # before the increment, like the reference's break
            chunk_index += 1
        if chunk_index > 0 and (
            chunk_index == num_chunks or chunk_index == m.max_num_chunks
        ):
            chunk_index -= 1
        return chunk_index, num_events, chains, stopped
