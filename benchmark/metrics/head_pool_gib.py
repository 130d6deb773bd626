"""head_pool_gib (layer: batch head): the device memory of the batch
head's CUDA graph pools after the window, in GiB (the ``pool_mib`` of each
``head`` graph in ``TurboMapper.graph_stats()``), the largest part of
``device_peak_gib``.  Nothing when the mapper captured no head graph."""

PREFIX = "head"


def read(run):
    mib = [g["pool_mib"] for g in run.graphs or []
           if g["graph"].startswith(PREFIX)]
    if not mib:
        return None
    return sum(mib) / 1024
