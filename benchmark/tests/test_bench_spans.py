"""The readers of the program's spans, on made-up stamps that carry spans
and on stamps that carry none (a program that records no spans)."""

from types import SimpleNamespace

import pytest

from benchmark import window
from benchmark.tests.test_bench_metrics import made_up_run
from benchmark.window import Call, RunData

READERS = ("epilogue_share", "head_stage_share", "head_quantize_share",
           "rescue_read_ms", "rescue_cpu_share")


def _span(name, t0, t1, **numbers):
    return SimpleNamespace(name=name, t0=t0, t1=t1, numbers=numbers)


def spanned_run():
    # two calls over a 2.0 s window: call 0 rescues two reads (20 ms, half
    # of it on the CPU, and 60 ms, all of it), call 1 none
    call0 = [_span("map.pass", 0.0, 0.9),
             _span("head.stage", 0.0, 0.05),
             _span("head.quantize", 0.05, 0.08),
             _span("round.loop", 0.1, 0.5),
             _span("round.epilogue", 0.5, 0.6),
             _span("rescue.read", 0.55, 0.57, cpu_s=0.01),
             _span("rescue.read", 0.6, 0.66, cpu_s=0.06),
             _span("rescue.drain", 0.6, 0.9)]
    call1 = [_span("map.pass", 1.0, 2.0),
             _span("head.stage", 1.0, 1.1),
             _span("head.quantize", 1.1, 1.2),
             _span("round.loop", 1.2, 1.8),
             _span("round.epilogue", 1.8, 2.0),
             _span("rescue.drain", 2.0, 2.0)]
    calls = [Call(0.0, 0.9, 0, list(range(10)), [object()] * 10,
                  dict(start=0.0, spans=call0)),
             Call(1.0, 2.0, 1, list(range(10)), [object()] * 10,
                  dict(start=1.0, spans=call1))]
    return RunData(calls)


def reader(name):
    return window.load_reader(name)


def test_span_readers():
    run = spanned_run()
    assert run.window_s == pytest.approx(2.0)
    assert reader("epilogue_share")(run) == pytest.approx(0.3 / 2.0)
    assert reader("head_stage_share")(run) == pytest.approx(0.15 / 2.0)
    assert reader("head_quantize_share")(run) == pytest.approx(0.13 / 2.0)
    assert reader("rescue_read_ms")(run) == pytest.approx(40.0)
    assert reader("rescue_cpu_share")(run) == pytest.approx(0.07 / 0.08)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_find_nothing_without_spans(name):
    """Stamps with no spans (a program that records none) and spans with
    none of the reader's name both leave the metric out."""
    assert reader(name)(made_up_run()) is None
    run = spanned_run()
    for c in run.calls:
        c.stamps["spans"] = [s for s in c.stamps["spans"]
                             if s.name == "map.pass"]
    assert reader(name)(run) is None
