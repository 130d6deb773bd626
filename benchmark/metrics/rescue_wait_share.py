"""rescue_wait_share (layer: rescue): the share of the window from each
call's last round loop's end until the call returns, the wait for the
reads the exact engine re-maps (``TurboMapper.last_pass["rescues"]``)."""


def read(run):
    wait = 0.0
    for c in run.calls:
        r = c.stamps.get("rescues")
        if r is None:
            return None
        wait += r[1] - r[0]
    return wait / run.window_s
