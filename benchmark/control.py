"""The check's control, on the card at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed: the cell's genome and read pool, the reference built from
them, and the window's first two calls in the window's order.  The
control is the reference put in the program's place with its batch head
computed a step below the configuration's f32 (the dequantized pA and the
z-scored event means in bfloat16, ``reference.events``): the sample that
a run draws from those calls is mapped by it, its answers (and the exact
engine's records of the reads it sends to the rescue) stand as the
program's, and ``compare.judge`` decides ``correct`` as it does for a
run.  The program is not run.  One JSON line a seed on standard output,
with ``correct`` and each number compared beside its limit.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_verdict(cell, inputs, ref, seed: int):
    """``compare.judge``'s verdict on the bf16 control's answers for the
    sample a run of ``seed`` would draw from the window's first two calls
    (``inputs`` and ``ref`` of that seed)."""
    from benchmark import compare, synthgen, window
    from benchmark.reference.rescue import Undecided

    rng = synthgen.rng_for(seed, "order")       # as window.drive draws it
    calls = [window.Call(0.0, 0.0, i, rng.permutation(len(part)).tolist(),
                         [], {})
             for i, part in enumerate(inputs.pools[:2])]
    run = window.RunData(calls)
    sample = compare.sampled_reads(run, inputs, compare.draw_sample(run, seed),
                                   cell.traffic["read_batch"], ref.cfg)
    got = ref.map_rounds([s.read for s in sample], "bf16")
    control = []
    for s, (rec, ovf, resc) in zip(sample, got):
        if resc:
            try:
                rec = ref.rescue(s.read)
            except Undecided:
                rec = None
        control.append(compare.Sampled(s.read, rec, ovf, resc))
    return compare.judge(ref, control, 0, seed)


def control_numbers(cell, seed: int, dev) -> dict:
    """The control's verdict at ``cell``'s size for ``seed``, as a dict."""
    from benchmark import workload
    from benchmark.reference import Reference

    inputs = workload.make_inputs(cell, seed, dev)
    t = time.perf_counter()
    ref = Reference(inputs.genome, inputs.pore, cell.config["turbo_params"],
                    dev)
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    v = control_verdict(cell, inputs, ref, seed)
    return dict(cell=cell.name, seed=seed, correct=v.correct,
                reference_build_s=t_build,
                judge_s=time.perf_counter() - t, notes=v.notes,
                compared=v.compared())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import workload

    if not torch.cuda.is_available():
        print("control: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = workload.load_cell(workload.load_benchmark(ROOT), args.workload,
                              HERE)
    for seed in args.seeds:
        out = control_numbers(cell, seed, torch.device("cuda", 0))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
