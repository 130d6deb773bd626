"""head_wait_share (layer: batch head): the share of the window in which
the caller waited for a batch head.  Per call, its start until its first
round loop, plus the gaps between one batch's round loop and the next's
(``TurboMapper.last_pass``: ``start``, ``rounds``)."""


def read(run):
    wait = 0.0
    for c in run.calls:
        rounds = c.stamps.get("rounds") or []
        if not rounds:
            return None
        wait += rounds[0][0] - c.stamps["start"]
        wait += sum(b[0] - a[1] for a, b in zip(rounds, rounds[1:]))
    return wait / run.window_s
