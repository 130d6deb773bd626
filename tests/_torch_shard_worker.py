"""One rank of a sharded turbo run (``sigmap_tpu_torch.parallel``): joins
the process group, builds its ShardMesh and TurboShardMapper, maps the
reads (--passes times) and writes what its last pass returned as JSON
(OUT/rank<R>.json).  It imports the port, torch,
numpy and the stdlib only, so it runs where JAX is not (on the card's
machine, launched by chip_smoke.py phase 11) as well as under
tests/test_torch_shard.py, which starts one per rank on the CPU.

    python tests/_torch_shard_worker.py --rank R --world N --mesh D I \\
        --coordinator localhost:PORT --backend gloo --device cpu \\
        --index PREFIX --signals DIR --read-batch B --out-dir OUT

Without --rank/--world/--coordinator it takes RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT from the environment, as ``torchrun
--nproc-per-node N tests/_torch_shard_worker.py --mesh D I ...`` sets them.
With --paf-dir each rank also writes its contiguous part of the records as
PAF (without mt:), and rank 0 merges the parts (``merge_host_paf``) into
merged.paf once every rank has written its part.  Any fault exits non-zero.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sigmap_tpu_torch.config import SigmapConfig  # noqa: E402
from sigmap_tpu_torch.index.build import SignalIndex  # noqa: E402
from sigmap_tpu_torch.io.paf import mapped_line, unmapped_line  # noqa: E402
from sigmap_tpu_torch.io.signals import load_all_read_signals  # noqa: E402
from sigmap_tpu_torch.mapping.turbo import TurboParams  # noqa: E402
from sigmap_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed, merge_host_paf)
from sigmap_tpu_torch.parallel.turbo_shard import (  # noqa: E402
    ShardMesh, TurboShardMapper)


def paf_line(rec, index):
    """The record's PAF line without its mt: tag."""
    line = (mapped_line(rec, index.ref_names[rec.ref_index],
                        index.ref_lengths[rec.ref_index])
            if rec.is_mapped else unmapped_line(rec))
    return "\t".join(x for x in line.strip().split("\t")
                     if not x.startswith("mt:"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--coordinator")
    ap.add_argument("--mesh", type=int, nargs=2, required=True,
                    metavar=("D", "I"))
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="process-group timeout, s")
    ap.add_argument("--index", required=True, help="SignalIndex prefix")
    ap.add_argument("--signals", required=True, help="directory of reads")
    ap.add_argument("--read-batch", type=int, required=True)
    ap.add_argument("--params", default="{}",
                    help="TurboParams fields as JSON")
    ap.add_argument("--threads", type=int, default=1,
                    help="torch intra-op threads and rescue threads")
    ap.add_argument("--sweep-cache", help="sweep tile-store cache directory")
    ap.add_argument("--passes", type=int, default=1,
                    help="map the reads this many times (the first cold)")
    ap.add_argument("--out-dir", required=True,
                    help="where it writes rank<R>.json")
    ap.add_argument("--paf-dir")
    ap.add_argument("--eager", action="store_true",
                    help="run the rounds and heads op by op, not as the "
                         "CUDA graphs a mapper on a GPU replays")
    a = ap.parse_args()

    torch.set_num_threads(a.threads)
    rank, world = initialize_distributed(a.coordinator, a.world, a.rank,
                                         backend=a.backend, timeout=a.timeout)
    D, I = a.mesh
    mesh = ShardMesh.create(D, I, a.device)
    cfg = SigmapConfig()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, read_batch=a.read_batch, num_threads=a.threads,
        sweep_cache_dir=a.sweep_cache))
    index = SignalIndex.load(a.index)
    signals = load_all_read_signals(a.signals, cfg.mapping.pa_lo,
                                    cfg.mapping.pa_hi)
    t0 = time.perf_counter()
    mapper = TurboShardMapper(index, cfg, mesh,
                              TurboParams(**json.loads(a.params)),
                              device=a.device)
    if a.eager:
        mapper._graphs = False
    setup_s = time.perf_counter() - t0
    map_s = []
    for _ in range(a.passes):
        t0 = time.perf_counter()
        records = mapper.streaming_map(signals)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        map_s.append(time.perf_counter() - t0)
        if len(records) != len(signals):
            raise SystemExit(f"rank {rank}: {len(records)} records for "
                             f"{len(signals)} reads")
    mapper.close()
    with open(os.path.join(a.out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, world=world, d=mesh.d, i=mesh.i,
                       setup_s=setup_s, map_s=map_s,
                       overflow=mapper.last_pass["overflow"],
                       rescued=mapper.last_pass["rescued"],
                       n_rescued_here=mapper.n_rescued,
                       graphs=mapper.graph_stats(),
                       records=[dataclasses.asdict(r) for r in records]), f)
    if a.paf_dir:
        # each rank writes its contiguous part of the records; rank 0
        # merges the parts once every rank has written its own
        lo, hi = (rank * len(records) // world,
                  (rank + 1) * len(records) // world)
        with open(os.path.join(a.paf_dir, f"part_{rank:03d}.paf"), "w") as f:
            for rec in records[lo:hi]:
                f.write(paf_line(rec, index) + "\n")
        dist.barrier(group=mesh.object_group)
        if rank == 0:
            merge_host_paf([os.path.join(a.paf_dir, f"part_{r:03d}.paf")
                            for r in range(world)],
                           os.path.join(a.paf_dir, "merged.paf"))
    print(f"rank {rank} ({mesh.d}, {mesh.i}): "
          f"{sum(r.is_mapped for r in records)}/{len(records)} mapped, "
          f"set-up {setup_s:.2f} s, passes " + ", ".join(
              f"{x:.2f}" for x in map_s) + " s", flush=True)
    # no rank leaves while another may still talk to it
    dist.barrier(group=mesh.object_group)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
