"""The reader of the rescue's chunk searches, on made-up stamps that carry
``rescue.search`` spans and on stamps that carry none (a program that
records no such span)."""

from benchmark import window
from benchmark.tests.test_bench_metrics import made_up_run
from benchmark.tests.test_bench_spans import _span, spanned_run


def test_rescue_device_share_reads_the_search_spans():
    """Three of call 0's four chunk searches ran on the card (device 1),
    one on the k-d tree: 0.75."""
    run = spanned_run()
    run.calls[0].stamps["spans"] += [
        _span("rescue.search", 0.55, 0.551, device=1, seeds=200,
              matches=16000),
        _span("rescue.search", 0.56, 0.561, device=1, seeds=198,
              matches=15000),
        _span("rescue.search", 0.60, 0.61, device=0, seeds=200,
              matches=900),
        _span("rescue.search", 0.62, 0.621, device=1, seeds=3, matches=0)]
    read = window.load_reader("rescue_device_share")
    assert read(run) == 0.75


def test_rescue_device_share_finds_nothing_without_search_spans():
    """Stamps with no spans, and spans with no rescue.search (the program
    before the card search), leave the metric out."""
    read = window.load_reader("rescue_device_share")
    assert read(made_up_run()) is None
    assert read(spanned_run()) is None
