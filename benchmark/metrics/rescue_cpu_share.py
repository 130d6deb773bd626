"""rescue_cpu_share (layer: rescue): the rescue threads' CPU time over
their wall time in the window's rescued reads (the ``cpu_s`` of the
program's ``rescue.read`` spans, summed, over their summed durations).
Below 1, a rescue thread waited while it ran a read: for the interpreter
lock or for a core.  Nothing when no read was rescued."""

from benchmark import spans


def read(run):
    found = spans.named(run, "rescue.read")
    wall = sum(s.t1 - s.t0 for s in found)
    if not wall:
        return None
    return sum(s.numbers["cpu_s"] for s in found) / wall
