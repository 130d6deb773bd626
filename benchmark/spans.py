"""The program's spans in a run's calls, for the per-layer readers: each
call's ``stamps`` (``TurboMapper.last_pass``) holds its pass's ``spans``
(``sigmap_tpu_torch/mapping/spans.py``), each with a ``name``, a start
``t0`` and end ``t1`` on ``time.perf_counter()`` and its ``numbers``.
A program that records no spans gives nothing."""


def named(run, name: str) -> list:
    """Every span called ``name`` of the window's calls, in call order;
    empty where the stamps carry no spans, or none of that name."""
    return [s for c in run.calls for s in c.stamps.get("spans") or ()
            if s.name == name]


def share(run, name: str):
    """The spans called ``name`` summed, over the window's wall; None
    where there are none."""
    found = named(run, name)
    if not found:
        return None
    return sum(s.t1 - s.t0 for s in found) / run.window_s
