"""Each per-layer reader, the end-to-end arithmetic and the trace
reduction, on made-up stamps and traces."""

import math

import pytest

from benchmark import devtrace, window
from benchmark.window import Call, RunData


def made_up_run(trace=None):
    # two calls of 10 reads; call 0: start 0.0, batches' rounds at
    # 0.1-0.4 and 0.5-0.7, rescues 0.7-0.9; call 1: start 1.0, rounds
    # 1.2-1.6, rescues 1.6-2.0
    calls = [
        Call(0.0, 0.9, 0, list(range(10)), [object()] * 10,
             dict(start=0.0, rounds=[(0.1, 0.4), (0.5, 0.7)],
                  round_host=[(0.001, 0.02), (0.001, 0.03)],
                  rescues=(0.7, 0.9), overflow=[1, 2], rescued=[2])),
        Call(1.0, 2.0, 1, list(range(10)), [object()] * 9,
             dict(start=1.0, rounds=[(1.2, 1.6)],
                  round_host=[(0.001, 0.04)], rescues=(1.6, 2.0),
                  overflow=[], rescued=[])),
    ]
    graphs = [dict(graph="round B=512 F=1024", pool_mib=102.0),
              dict(graph="head rows=4096 Cs=4000", pool_mib=1024.0),
              dict(graph="head rows=1024 Cs=4000", pool_mib=512.0)]
    return RunData(calls, rescued=3, graphs=graphs, trace=trace)


def made_up_trace():
    ev = [
        dict(ph="X", cat="kernel", name="void (anonymous namespace)::"
             "sweep_kernel<6>(float const*)", ts=0, dur=100_000),
        dict(ph="X", cat="kernel", name="void (anonymous namespace)::"
             "chain_fused_kernel<false>(int const*)", ts=50_000,
             dur=100_000),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=300_000,
             dur=100_000),
        dict(ph="X", cat="cpu_op", name="aten::copy_", ts=160_000,
             dur=100_000),
        dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch",
             ts=400_000, dur=600_000),
    ]
    busy_ms, by_name = devtrace.device_busy(ev)
    return ev, devtrace.DeviceTrace(
        busy_ms / 1000, {k: (ms / 1000, n) for k, (ms, n) in by_name.items()},
        devtrace.host_gaps(ev))


def reader(name):
    return window.load_reader(name)


def test_window_and_end_to_end():
    run = made_up_run()
    assert run.window_s == pytest.approx(2.0)
    assert run.attempted == 20 and run.completed == 19
    assert window.reads_per_s(run) == pytest.approx(9.5)
    assert window.call_p95_s(run) == pytest.approx(0.995)


def test_host_clock_readers():
    run = made_up_run()
    # waits: 0.1 + 0.1 (call 0) + 0.2 (call 1) over 2.0 s
    assert reader("head_wait_share")(run) == pytest.approx(0.2)
    assert reader("round_loop_share")(run) == pytest.approx(0.9 / 2.0)
    assert reader("round_return_ms")(run) == pytest.approx(30.0)
    assert reader("rescue_wait_share")(run) == pytest.approx(0.6 / 2.0)
    assert reader("rescued_share")(run) == pytest.approx(3 / 20)


def test_entry_and_pool_readers():
    run = made_up_run()
    assert reader("window_reads_per_s")(run) == pytest.approx(9.5)
    assert reader("call_wall_p95_s")(run) == pytest.approx(0.995)
    assert reader("head_pool_gib")(run) == pytest.approx(1.5)
    assert reader("round_pool_gib")(run) == pytest.approx(102 / 1024)
    # a mapper with no graph of that kind leaves the metric out
    run.graphs = [g for g in run.graphs if g["graph"].startswith("round")]
    assert reader("head_pool_gib")(run) is None
    run.graphs = None
    assert reader("round_pool_gib")(run) is None


def test_trace_readers_and_their_silence_without_a_trace():
    run = made_up_run()
    for name in ("sweep_ms_per_kread", "chain_ms_per_kread",
                 "device_idle_share"):
        assert reader(name)(run) is None
    _, tr = made_up_trace()
    run = made_up_run(tr)
    # 100 ms of B3 and of B4 over 19 reads
    assert reader("sweep_ms_per_kread")(run) == pytest.approx(
        100 / 0.019)
    assert reader("chain_ms_per_kread")(run) == pytest.approx(100 / 0.019)
    # busy: [0, 150] + [300, 400] ms = 0.25 s of the 2.0 s window
    assert reader("device_idle_share")(run) == pytest.approx(1 - 0.125)
    # a trace without a kernel of that name leaves the metric out
    tr.by_name = {k: v for k, v in tr.by_name.items() if "sweep" not in k}
    assert reader("sweep_ms_per_kread")(run) is None


def test_host_gaps_and_breakdown():
    ev, tr = made_up_trace()
    gaps = tr.gaps
    # gaps: 150-300 ms and 400-1000 ms
    assert gaps["n_gaps"] == 2
    assert gaps["gap_ms"] == pytest.approx(750.0)
    ops = dict(gaps["host_ops"])
    assert ops["cudaGraphLaunch"] == pytest.approx(600.0)
    assert ops["aten::copy_"] == pytest.approx(100.0)
    bd = tr.breakdown()
    assert len(bd["device_ops"]) == 3 and len(bd["idle_gaps"]) == 2
    assert bd["device_ops"][0][1] == pytest.approx(0.1)
    # the longest gap first, named by its longest host op
    assert bd["idle_gaps"][0][0].startswith("cudaGraphLaunch (after Memcpy")
    assert bd["idle_gaps"][0][1] == pytest.approx(0.6)
    assert bd["idle_gaps"][1][0].startswith("aten::copy_")
    assert all(isinstance(n, str) and isinstance(s, float) and
               not math.isnan(s) for n, s in bd["idle_gaps"])
