"""round_loop_share (layer: round): the share of the window inside the
batches' round loops (``TurboMapper.last_pass["rounds"]``: each batch's
rounds, the state's download and its records)."""


def read(run):
    inside = 0.0
    for c in run.calls:
        rounds = c.stamps.get("rounds") or []
        if not rounds:
            return None
        inside += sum(b - a for a, b in rounds)
    return inside / run.window_s
