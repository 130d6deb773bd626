"""round_pool_gib (layer: round): the device memory of the turbo round's
CUDA graph pools after the window, in GiB (the ``pool_mib`` of each
``round`` graph in ``TurboMapper.graph_stats()``).  Nothing when the
mapper captured no round graph."""

PREFIX = "round"


def read(run):
    mib = [g["pool_mib"] for g in run.graphs or []
           if g["graph"].startswith(PREFIX)]
    if not mib:
        return None
    return sum(mib) / 1024
