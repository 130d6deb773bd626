"""call_wall_p95_s (layer: entry): the 95th percentile of the window's
``streaming_map`` call walls, timed by the harness around each call
(``window.call_p95_s``): how long a call's reads wait for their records.
Per layer, since its runs spread too widely to hold it end to end."""

from benchmark import window


def read(run):
    if not run.calls:
        return None
    return window.call_p95_s(run)
