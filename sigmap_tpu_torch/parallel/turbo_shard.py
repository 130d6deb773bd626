"""Multi-device turbo mapping over torch.distributed: reads over "data",
the sweep tile store over "index" (counterpart of
``sigmap_tpu/parallel/turbo_shard.py``; read its docstring for the scheme).

* A mesh of D x I ranks (``ShardMesh``); rank r is (d, i) = divmod(r, I).
  Reads are split over "data"; the cell-sorted tile store
  (``index/sweep.py``) over "index" as contiguous tile ranges, each shard
  with a rebased cumulative cell table (``ShardedSweep``), so B3 searches a
  shard exactly as it searches the whole store.
* Every rank runs the single-device round (``mapping/turbo.py:turbo_round``)
  on its reads and its tiles.  Per-seed match slots merge across the
  rank's index group with one all-gather and the K smallest d^2, ties to
  the lower shard-major slot as ``jax.lax.top_k`` breaks them
  (``merge_shard_matches``), and the exact match totals with a sum: the
  only collectives of the round loop.  On a GPU a round is two replayed
  CUDA graphs, up to the sweep's outputs and from the merged slots on,
  with the merge run eagerly between them, whatever the backend
  (``mapping/graphs.py:RoundGraph``).
* Chaining, stop and summary state is data-sharded and index-replicated:
  the I ranks of a data group hold the same state, run the same rounds and
  leave the loop together.  Collectives run only inside an index group, so
  data groups may run different numbers of rounds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..config import SigmapConfig
from ..index.build import SignalIndex
from ..index.sweep import META_POS_BITS, PAD_COORD, SweepIndex
from ..io.paf import PAFRecord
from ..io.signals import ReadSignal
from ..mapping.turbo import (TileStore, TurboMapper, TurboParams, _on_stream,
                              _put)
from .multihost import local_read_rows

INF = np.float32(1.0e30)


@dataclass
class ShardedSweep:
    """SweepIndex split into I contiguous tile ranges + rebased cum."""

    tiles: np.ndarray   # [I, Tl, 8, TILE]
    meta: np.ndarray    # [I, Tl, 8, TILE//8]
    cum: np.ndarray     # [I, prod(radixes)+1] rebased per shard
    rot: np.ndarray     # [dim, dim] (replicated)
    mu: np.ndarray      # [dim]
    origin: np.ndarray  # [bd]
    geom: tuple         # (radixes, span, cell_width)
    n_windows: int
    tile: int
    pos_bits: int = META_POS_BITS   # meta's split (index/sweep.py)

    @staticmethod
    def build(idx: SignalIndex, radius: float, n_shards: int,
              tile: int = 1024, cache_dir: str | None = None
              ) -> "ShardedSweep":
        """turbo_shard.py:64-91 on ``SweepIndex.build_cached``: padding
        tiles hold PAD_COORD in row 0 and zero meta; shard i's table is
        clip(cum - i * Tl * tile, 0, Tl * tile)."""
        sw, tiles, meta = SweepIndex.build_cached(idx, radius, tile=tile,
                                                  cache_dir=cache_dir)
        tiles = tiles.numpy()
        meta = meta.numpy()
        T = len(tiles)
        Tl = -(-T // n_shards)
        pad = Tl * n_shards - T
        if pad:
            pt = np.zeros((pad, 8, tile), np.float32)
            pt[:, 0, :] = PAD_COORD
            tiles = np.concatenate([tiles, pt], axis=0)
            meta = np.concatenate(
                [meta, np.zeros((pad, 8, tile // 8), np.int32)], axis=0
            )
        W_l = Tl * tile
        cum = np.stack([
            np.clip(sw.cum.astype(np.int64) - i * W_l, 0, W_l).astype(np.int32)
            for i in range(n_shards)
        ])
        return ShardedSweep(
            tiles=tiles.reshape(n_shards, Tl, 8, tile),
            meta=meta.reshape(n_shards, Tl, 8, tile // 8),
            cum=cum, rot=sw.rot, mu=sw.mu, origin=sw.origin,
            geom=(sw.radixes, sw.span, sw.cell_width),
            n_windows=sw.n_windows, tile=tile, pos_bits=sw.pos_bits,
        )


def tile_store_from_shard(ss: ShardedSweep, i: int, device) -> TileStore:
    """Shard ``i`` of ``ss`` on ``device``, as the TileStore that B3's
    wrapper searches (its tile count is the shard's Tl)."""
    dev = torch.device(device)
    radixes, span, cell_width = ss.geom
    return TileStore(
        tiles=_put(ss.tiles[i], np.float32, dev),
        meta=_put(ss.meta[i], np.int32, dev),
        cum=_put(ss.cum[i], np.int32, dev),
        rot=_put(ss.rot, np.float32, dev), mu=_put(ss.mu, np.float32, dev),
        origin=_put(ss.origin, np.float32, dev), radixes=tuple(radixes),
        span=span, cell_width=cell_width, tile=ss.tile, pos_bits=ss.pos_bits,
    )


def merge_shard_matches(am, ad, aw, cnt_sum, K: int):
    """Merge the index shards' match slots of every seed
    (turbo_shard.py:100-115 without its collectives).

    am/ad: the gathered [I, Q, K] i32 meta and f32 d^2, aw: [I, Q] i32
    slots each shard filled, cnt_sum: [Q] i32 exact totals summed over the
    shards.  Unfilled slots count as d^2 = INF.  Per seed the I*K slots,
    shard-major, are sorted by d^2 stably, so equal d^2 keep the lower
    slot first as ``jax.lax.top_k`` keeps them (``torch.topk`` promises no
    order among ties), and the first K are kept.  Returns (m_meta [Q, K],
    m_d2 [Q, K], cnt [Q], wrote [Q] i32)."""
    I, Q, _ = am.shape
    valid = (torch.arange(K, device=am.device)[None, None, :]
             < aw[:, :, None])
    d = torch.where(valid, ad, float(INF))
    d = d.permute(1, 0, 2).reshape(Q, I * K)
    mm = am.permute(1, 0, 2).reshape(Q, I * K)
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    m_d2 = d_sorted[:, :K].contiguous()
    m_meta = torch.gather(mm, 1, order[:, :K])
    wrote = (m_d2 < float(INF / 2)).sum(dim=1).to(torch.int32)
    return m_meta, m_d2, cnt_sum, wrote


@dataclass
class ShardMesh:
    """This rank's place in a ("data", "index") mesh of D x I ranks:
    (d, i) = divmod(rank, I); its index group (the I ranks of data row d,
    over which the match slots merge), its data group (the D ranks of
    index column i), a gloo group of all ranks for host objects, and the
    device its tensors live on."""

    D: int
    I: int
    rank: int
    d: int
    i: int
    index_group: object
    data_group: object
    object_group: object
    device: torch.device

    @staticmethod
    def create(D: int, I: int, device) -> "ShardMesh":
        """The mesh over the initialized default process group, whose world
        size must be D * I.  Every rank calls this, and it creates every
        group on every rank in one order (``dist.new_group``'s rule).  The
        index and data groups use the default group's backend; the object
        group is gloo (the default group itself if that is gloo), so that
        Python objects never travel through a device."""
        world = dist.get_world_size()
        if world != D * I:
            raise ValueError(f"a {D} x {I} mesh needs {D * I} ranks, the "
                             f"process group has {world}")
        dev = torch.device(device)
        if dist.get_backend() == "nccl" and dev.type != "cuda":
            raise ValueError(f"NCCL ranks need a CUDA device, not {dev}")
        rank = dist.get_rank()
        d, i = divmod(rank, I)
        index_groups = [dist.new_group([r * I + c for c in range(I)])
                        for r in range(D)]
        data_groups = [dist.new_group([r * I + c for r in range(D)])
                       for c in range(I)]
        obj = (dist.group.WORLD if dist.get_backend() == "gloo"
               else dist.new_group(backend="gloo"))
        return ShardMesh(D=D, I=I, rank=rank, d=d, i=i,
                         index_group=index_groups[d],
                         data_group=data_groups[i], object_group=obj,
                         device=dev)


class TurboShardMapper(TurboMapper):
    """TurboMapper over a ShardMesh: same ``streaming_map(signals) ->
    list[PAFRecord]`` as the JAX class (turbo_shard.py:152-257).

    Every rank is given every read.  Rank (d, i) maps rows [d * Bl,
    (d + 1) * Bl) of each global batch of ``runtime.read_batch`` reads (Bl
    = read_batch // D) against its tile shard, merging each round's match
    slots over its index group.  A read that ends unmapped after a
    capacity overflow is re-mapped by the exact engine once, on index rank
    0 of its data group, and only that rank builds the rescue oracle.  At
    the end of the pass the ranks exchange their records over the object
    group, and every rank returns every read's record in input order.

    Records equal the single-device mapper's apart from ``mt:``: each rank
    splits its own rounds' wall time among its active reads, where the JAX
    class gathers each round's done flags over "data" and every read sees
    the whole mesh's rounds (``_unpack_host_sig``, turbo_shard.py:250-257).
    A read whose seeds hold more than K matches can differ too: the merge
    keeps the K smallest d^2 over all shards, one device the closest K in
    scan order; such a read is flagged in row 7 of rb_i and rescued if it
    ends unmapped (``last_pass["overflow"]``)."""

    def __init__(self, index: SignalIndex, config: SigmapConfig,
                 mesh: ShardMesh, params: TurboParams | None = None, *,
                 device, oracle=None):
        if torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        B = config.runtime.read_batch
        if B % mesh.D:
            raise ValueError("read_batch must divide the data axis")
        self.mesh = mesh
        self.read_batch = B
        params = params if params is not None else TurboParams()
        if mesh.i != 0:
            params = dataclasses.replace(params, rescue=False)
        local = dataclasses.replace(config, runtime=dataclasses.replace(
            config.runtime, read_batch=B // mesh.D))
        super().__init__(index, local, params, device=device, oracle=oracle)
        if mesh.i != 0:
            # index rank 0 of the data group rescues these reads
            self._ovf_warned = True
        self._merge_matches = self._merge
        if mesh.D * mesh.I > 1:
            # every rank of an index group must reach its collectives in
            # one order (turbo_shard.py:210-221)
            self._overlap_batches = False

    def _tile_store(self) -> TileStore:
        """This rank's shard of the tile store.  With a sweep cache, rank 0
        builds and writes it before the others read it."""
        cache = self.cfg.runtime.sweep_cache_dir
        if cache and self.mesh.rank != 0:
            dist.barrier(group=self.mesh.object_group)
        ss = ShardedSweep.build(self.index, self.cfg.mapping.search_radius,
                                self.mesh.I, tile=self.p.TILE,
                                cache_dir=cache)
        if cache and self.mesh.rank == 0:
            dist.barrier(group=self.mesh.object_group)
        return tile_store_from_shard(ss, self.mesh.i, self.device)

    def _merge(self, m_meta, m_d2, cnt, wrote):
        """The round's merge_matches: all-gather of the slots and the slot
        counts, a sum of the exact totals, over the index group."""
        g, I = self.mesh.index_group, self.mesh.I
        # on a GPU the collectives run on the device's current stream
        with _on_stream(self.device, None):
            parts = []
            for t in (m_meta, m_d2, wrote):
                out = [torch.empty_like(t) for _ in range(I)]
                dist.all_gather(out, t.contiguous(), group=g)
                parts.append(torch.stack(out))
            cnt = cnt.contiguous().clone()
            dist.all_reduce(cnt, op=dist.ReduceOp.SUM, group=g)
        return merge_shard_matches(*parts, cnt, self.p.K)

    def streaming_map(self, signals: list[ReadSignal]) -> list[PAFRecord]:
        mesh = self.mesh
        rows = local_read_rows(len(signals), self.read_batch, mesh.d, mesh.D)
        local = super().streaming_map([signals[j] for j in rows])
        mine = [dataclasses.replace(r, read_id=int(rows[r.read_id]))
                for r in local]
        p = self.last_pass
        flags = [[int(rows[j]) for j in p[k]] for k in ("overflow",
                                                         "rescued")]
        every = [None] * dist.get_world_size(mesh.object_group)
        dist.all_gather_object(every, (mesh.i, mine, flags),
                               group=mesh.object_group)
        every = [x for x in every if x[0] == 0]
        p["overflow"], p["rescued"] = (
            sorted(j for x in every for j in x[2][k]) for k in (0, 1))
        return sorted((r for x in every for r in x[1]),
                      key=lambda r: r.read_id)
