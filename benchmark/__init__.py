"""The benchmark of sigmap_tpu_torch (see run.py and PERF.md)."""
