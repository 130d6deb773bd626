"""rescue_device_share (layer: rescue): the share of the window's rescue
chunk searches that ran on the card (the program's ``rescue.search`` spans,
one a chunk of a rescued read, whose ``device`` number is 1 on the card and
0 on the host k-d tree).  Nothing where no chunk was searched, or where the
program records no such span."""

from benchmark import spans


def read(run):
    found = spans.named(run, "rescue.search")
    if not found:
        return None
    return sum(s.numbers["device"] for s in found) / len(found)
