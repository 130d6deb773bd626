"""The result line's shape, and a run with no card."""

import json
import os
import subprocess
import sys

from benchmark import compare, run as run_mod, workload
from benchmark.tests.test_bench_metrics import made_up_run, made_up_trace

ROOT = workload.ROOT


def test_metrics_follow_the_cell_and_the_trace_switch():
    bench = workload.load_benchmark()
    values = dict(reads_per_s=1.0, device_peak_gib=3.0, setup_s=4.0)
    for w in bench["workloads"]:
        m = run_mod.metrics_of(bench, w["name"], made_up_run(), values,
                               False)
        want = [e["name"] for e in bench["end_to_end"]
                if w["name"] in e.get("workloads", [w["name"]])]
        assert list(m) == want
        assert "setup_s" in m and len(m) >= 2
        assert all(set(v) == {"value", "unit"} for v in m.values())
    _, tr = made_up_trace()
    for w in bench["workloads"]:
        m = run_mod.metrics_of(bench, w["name"], made_up_run(tr), values,
                               True)
        assert set(m) == {e["name"] for e in bench["per_layer"]
                          if w["name"] in e.get("workloads", [w["name"]])}


def test_result_line_keys_and_compared_last():
    _, tr = made_up_trace()
    run = made_up_run(tr)
    v = compare.Verdict(numbers=dict(records_differing=(0, 0),
                                     reads_failed=(1, 0)))
    device = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1,
                  memory_peak_bytes=123)
    out = run_mod.result_line(v, run, {"x": dict(value=1.0, unit="s")},
                              device)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "compared"]
    assert out["correct"] is False          # a read had no record
    assert out["attempted"] == 20 and out["failed"] == 1
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] == 2.0
    assert out["compared"]["reads_failed"] == dict(value=1, limit=0)
    json.dumps(out)


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "ecoli.short", "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
