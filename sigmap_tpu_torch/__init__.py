"""PyTorch + CUDA port of sigmap_tpu's mapper.

The JAX package ``sigmap_tpu`` stays the reference.  This package mirrors
its module names (``signal/events.py``, ``signal/events_ref.py``,
``ops/sweep_kernel.py``, ``ops/chain_fused.py``, ``ops/sdtw_kernel.py``,
``mapping/sweep_search.py``, ``mapping/turbo.py``, ``mapping/seeding.py``,
``mapping/driver.py``, ``oracle.py``, ``debug_modes.py``, ``cli.py``,
``parallel/turbo_shard.py``) and keeps its own copies of the JAX package's
JAX-free host modules (``config``, ``io``, ``index``, ``native``,
``mapping.chain``, ``ops.cwt``, ``synth``, ``evaluate``, ``ops.fastdtw``,
``parallel.multihost``).  It never imports JAX.

``parallel`` runs the turbo mapper over several processes with
torch.distributed: reads split over a "data" axis of ranks, the sweep
tile store over an "index" axis, each round's match slots merged by an
all-gather and a stable top-K.  The backend (NCCL or gloo) is always the
caller's.

Every Pallas kernel of the JAX package has a hand-written CUDA C++ kernel
for Hopper (``csrc/``) and a plain PyTorch version beside it.  A wrapper
runs the plain version on a CPU tensor and launches the kernel on a CUDA
tensor; there is no fallback between the two.  Every entry point takes an
explicit ``device``.
"""

from ._build import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
