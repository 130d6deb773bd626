"""A cell is added from data files alone: an entry in BENCHMARK.json and
a configuration and traffic file, found by name."""

import json
import os
import shutil

from benchmark import workload


def test_a_cell_added_from_data_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(workload.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = workload.load_benchmark()
    cfg = json.load(open(root / "benchmark/configs/ecoli-k12.json"))
    cfg.update(name="tiny-plasmid", contigs=[["p1", 30_000]])
    json.dump(cfg, open(root / "benchmark/configs/tiny-plasmid.json", "w"))
    traffic = json.load(open(root / "benchmark/traffic/short-512.json"))
    traffic.update(name="short-8", reads_per_call=8, read_batch=8,
                   pool_calls=2)
    json.dump(traffic, open(root / "benchmark/traffic/short-8.json", "w"))
    bench["configs"].append(dict(
        name="tiny-plasmid", source="made up for a test",
        file="benchmark/configs/tiny-plasmid.json", reduced=[],
        why="a test"))
    bench["workloads"].append(dict(name="tiny.short", config="tiny-plasmid",
                                   traffic="short-8", chips=1, why="a test"))
    json.dump(bench, open(root / "BENCHMARK.json", "w"))

    loaded = workload.load_benchmark(str(root))
    cell = workload.load_cell(loaded, "tiny.short", str(root / "benchmark"))
    assert cell.config["contigs"] == [["p1", 30_000]]
    assert cell.traffic["reads_per_call"] == 8
    inp = workload.make_inputs(cell, 7)
    assert [len(h) for h in inp.pools] == [8, 8]
    assert len(inp.genome[0][1]) == 30_000
