"""rescue_read_ms (layer: rescue): the median ms of one rescued read's
exact-engine run on its rescue thread, over the window's rescued reads
(the program's ``rescue.read`` spans).  Nothing when no read was
rescued."""

import statistics

from benchmark import spans


def read(run):
    found = spans.named(run, "rescue.read")
    if not found:
        return None
    return statistics.median(s.t1 - s.t0 for s in found) * 1000
