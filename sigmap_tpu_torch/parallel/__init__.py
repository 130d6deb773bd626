"""Multi-device turbo mapping over torch.distributed (counterpart of
``sigmap_tpu/parallel/``): reads split over a "data" axis of ranks, the
sweep tile store over an "index" axis (``turbo_shard``), and the process
set-up and host I/O helpers of a multi-process run (``multihost``)."""
