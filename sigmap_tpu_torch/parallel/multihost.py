"""Multi-process orchestration helpers (counterpart of
``sigmap_tpu/parallel/multihost.py``).

The reference is single-process (OpenMP threads, sigmap.cc:618).  The port
scales across processes with torch.distributed:

* ``initialize_distributed`` on every process, with an explicit backend:
  NCCL where each rank has a GPU of its own, gloo on the CPU and for
  several ranks on one card;
* the ("data", "index") mesh of ``parallel.turbo_shard.ShardMesh`` spans
  the ranks;
* read I/O stays host-local: ``shard_files_for_host`` gives each host its
  share of the signal files, ``local_read_rows`` each rank its rows of a
  global batch;
* per-host PAF partials are concatenated rank-major at the end
  (``merge_host_paf``, the reference's thread-buffer merge,
  sigmap.cc:217-241, across hosts).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *, backend: str,
                           timeout: float) -> tuple[int, int]:
    """``dist.init_process_group`` for this process; returns (rank,
    world_size).

    ``coordinator_address`` ("host:port") is rank 0's TCP store; without
    it the address comes from the environment that ``torchrun`` sets
    (MASTER_ADDR, MASTER_PORT), and so do the rank and world size that are
    not given (RANK, WORLD_SIZE).  ``backend`` is "nccl" or "gloo", never
    chosen here.  A collective that waits longer than ``timeout`` seconds
    (a rank that diverged or died) fails instead of hanging."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise ValueError("no coordinator_address and no "
                             + ", ".join(missing) + " in the environment")
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("the world size and this process's rank are needed "
                         "(arguments, or WORLD_SIZE and RANK)")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return dist.get_rank(), dist.get_world_size()


def shard_files_for_host(paths: list[str], process_id: int,
                         num_processes: int) -> list[str]:
    """Deterministic round-robin file sharding (host-local I/O)."""
    return [p for i, p in enumerate(sorted(paths)) if i % num_processes == process_id]


def merge_host_paf(partial_paths: list[str], out_path: str) -> int:
    """Concatenate per-host PAF partials rank-major (the cross-host analog
    of the reference's thread-buffer merge, sigmap.cc:217-241)."""
    n = 0
    with open(out_path, "w") as out:
        for p in sorted(partial_paths):
            with open(p) as f:
                for line in f:
                    out.write(line)
                    n += 1
    return n


def local_read_rows(n_reads: int, read_batch: int, d: int,
                    n_data: int) -> np.ndarray:
    """The reads (indices into the input order) that data rank ``d`` of
    ``n_data`` maps: rows [d * Bl, (d + 1) * Bl) of each global batch of
    ``read_batch`` reads, Bl = read_batch // n_data (the rows that
    ``global_read_batch``, multihost.py:69-76, places on this host)."""
    if read_batch % n_data:
        raise ValueError("read_batch must divide the data axis")
    rows = np.arange(n_reads)
    return rows[(rows % read_batch) // (read_batch // n_data) == d]
