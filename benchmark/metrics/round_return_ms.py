"""round_return_ms (layer: round): the median over the window's rounds of
the ms from a round's start until its host signal is back
(``TurboMapper.last_pass["round_host"]``, second of each pair)."""

import statistics


def read(run):
    back = [pair[1] for c in run.calls
            for pair in c.stamps.get("round_host") or []]
    if not back:
        return None
    return statistics.median(back) * 1000
