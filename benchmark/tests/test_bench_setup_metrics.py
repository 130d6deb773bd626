"""The readers of the set-up metrics (setup_build_s, store_gib) on made-up
stamps: what the last call carries, and nothing from a program whose
stamps carry neither."""

import pytest

from benchmark import window
from benchmark.window import Call, RunData
from sigmap_tpu_torch.mapping.spans import Span


def run_with(stamps_list):
    return RunData([Call(float(i), i + 0.5, 0, [0], [object()], st)
                    for i, st in enumerate(stamps_list)])


def test_setup_build_s_sums_the_last_calls_build_spans():
    build = [Span("setup.index", 1.0, 3.5), Span("setup.tree", 3.5, 20.0),
             Span("setup.tile_store", 20.0, 21.25)]
    run = run_with([dict(build=build[:1]), dict(build=build)])
    assert window.load_reader("setup_build_s")(run) == pytest.approx(20.25)


def test_store_gib_reads_the_last_calls_store_bytes():
    run = run_with([dict(store_bytes=1 << 30),
                    dict(store_bytes=5 * (1 << 30) // 2)])
    assert window.load_reader("store_gib")(run) == pytest.approx(2.5)


@pytest.mark.parametrize("name", ["setup_build_s", "store_gib"])
def test_a_program_without_them_gives_nothing(name):
    run = run_with([dict(start=0.0, spans=[]), dict(build=[])])
    assert window.load_reader(name)(run) is None
