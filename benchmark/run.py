"""Run one cell of the benchmark of ``sigmap_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's genome and read pool from the seed, builds the
port's index, rescue oracle and ``TurboMapper`` on the card, and warms up
every shape the window uses (one call on each part of the pool).  The
window drives ``TurboMapper.streaming_map`` in a closed loop for
``--seconds``.  Then the program is freed and a plain reference re-maps a
sample of the window's reads drawn from the seed, which decides
``correct``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``, then ``compared``: each number the
check compared, with its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# modules that must not be loaded in the process that prints the result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "sigmap_tpu")

GIB = 1 << 30


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metrics_of(bench: dict, cell: str, run, values: dict,
               traced: bool) -> dict:
    """The result's ``metrics``: untraced, the cell's end-to-end metrics
    from ``values``; traced, each per-layer metric's reader on ``run``
    (a reader that finds nothing leaves its metric out)."""
    from benchmark import window

    out = {}
    for m in bench["per_layer"] if traced else bench["end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        v = (window.load_reader(m["name"], HERE)(run) if traced
             else values[m["name"]])
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def spans_of(bench: dict, run) -> dict:
    """The per-layer metrics that the program's own stamps and counters
    give (not the device trace), for every run: what moved when a run's
    rate did."""
    from benchmark import window

    return {m["name"]: window.load_reader(m["name"], HERE)(run)
            for m in bench["per_layer"] if m["source"] != "device_trace"}


def result_line(verdict, run, metrics: dict, device: dict) -> dict:
    """The last line's object; ``compared`` comes last."""
    out = dict(correct=verdict.correct, attempted=run.attempted,
               failed=sum(c.n - len(c.records) for c in run.calls),
               metrics=metrics, device=device)
    if run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.window_s)
        out["breakdown"] = run.trace.breakdown()
    out["compared"] = verdict.compared()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import compare, synthgen, window, workload

    bench = workload.load_benchmark(ROOT)
    cell = workload.load_cell(bench, args.workload, HERE)
    import torch

    if not torch.cuda.is_available():
        log("benchmark: no CUDA device visible")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"benchmark: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)

    # ---- set-up ----------------------------------------------------------
    t = time.perf_counter()
    inputs = workload.make_inputs(cell, args.seed, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_inputs = time.perf_counter() - t
    t = time.perf_counter()
    mapper, parts = workload.build_mapper(cell, inputs)
    t_mapper = time.perf_counter() - t
    t = time.perf_counter()
    for part in parts:                # every shape the window's calls use
        mapper.streaming_map(part)
    torch.cuda.synchronize(dev)
    t_warm = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rescued0 = mapper.n_rescued
    probe_ms = [window.host_probe_ms()]
    gc.collect()
    gc.freeze()                 # set-up's objects leave the collector
    setup_s = time.perf_counter() - T_START
    log(f"benchmark: {cell.name} seed {args.seed}: set-up {setup_s:.3f} s "
        f"(inputs {t_inputs:.3f}, index+oracle+mapper {t_mapper:.3f}, "
        f"warm-up {t_warm:.3f}) on {kind}")

    # ---- the window ------------------------------------------------------
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    run = window.drive(mapper, parts, args.seconds, args.seed,
                       lambda: torch.cuda.synchronize(dev))
    if prof is not None:
        prof.__exit__(None, None, None)
    gc.unfreeze()
    probe_ms.append(window.host_probe_ms())
    run.rescued = mapper.n_rescued - rescued0
    run.graphs = mapper.graph_stats()
    window_peak = torch.cuda.max_memory_reserved(dev)
    memory_peak = max(setup_peak, window_peak)
    if prof is not None:
        from benchmark import devtrace

        t = time.perf_counter()
        run.trace = devtrace.reduce_profile(prof)
        del prof
        log(f"benchmark: trace read in {time.perf_counter() - t:.3f} s")

    # what the run saw besides its metrics (earlier lines)
    from sigmap_tpu_torch import LAUNCHES

    hits = [(r.read_name, "+" if r.direction == 1 else "-", r.ref_index,
             r.fragment_start, r.fragment_start + r.fragment_length)
            for c in run.calls for r in c.records if r.is_mapped]
    mapped, correct_truth = synthgen.score_hits(hits, inputs.truths.values())
    on_target = sum(1 for c in run.calls for j in c.order
                    if inputs.truths[inputs.pools[c.part][j][0]].on_target)
    info = dict(
        cell=cell.name, seed=args.seed, calls=len(run.calls),
        attempted=run.attempted, completed=run.completed,
        window_s=run.window_s, rescued=run.rescued,
        mapped_share=mapped / max(1, run.attempted),
        correct_share_of_on_target=correct_truth / max(1, on_target),
        host_probe_ms=probe_ms, spans=spans_of(bench, run),
        graphs=run.graphs, launches=dict(LAUNCHES),
        device_peak_gib=window_peak / GIB, setup_peak_gib=setup_peak / GIB)
    print(json.dumps(dict(info=info)), flush=True)

    # ---- free the program, then the reference decides `correct` ----------
    mapper.close()
    del mapper, parts
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    verdict = compare.check(cell, inputs, run, args.seed, dev)
    log(f"benchmark: reference took {time.perf_counter() - t:.3f} s")

    values = dict(reads_per_s=window.reads_per_s(run),
                  device_peak_gib=window_peak / GIB, setup_s=setup_s)
    metrics = metrics_of(bench, cell.name, run, values, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"benchmark: forbidden modules loaded: {', '.join(found)}")
        return 3
    device = dict(platform="gpu", kind=kind, count=cell.chips,
                  memory_peak_bytes=int(memory_peak))
    out = result_line(verdict, run, metrics, device)
    for line in verdict.lines():
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
