"""window_reads_per_s (layer: entry): ``reads_per_s`` per layer, in the
cells whose runs spread too widely to hold it end to end: records of every
read of the completed calls over the window (``window.reads_per_s``)."""

from benchmark import window


def read(run):
    if not run.calls:
        return None
    return window.reads_per_s(run)
