"""Wall time of the port's two sDTW align modes through the CLI, in one or
more checkouts of the port, on one CUDA card.

``--debug-mode dtw-align`` and ``cwt-align`` run on chip_smoke.py's debug
workload (a 48,502-base reference, 64 reads of 3000 bases), made once into
build/align_walls/.  Each checkout runs in a process of its own, in the
order given: one untimed run of each mode (kernel build, CUDA start-up),
then ``--reps`` timed runs.  Every checkout must print the same alignment
text.  To compare two commits, unpack the other one into a directory that
.gitignore lists and alternate them:

    python3 tools_torch_align_walls.py --trees .archive/parent . . .archive/parent

Prints one line per checkout and mode, then one JSON object of every wall.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MODES = ("dtw-align", "cwt-align")


def child(tree, work, reps):
    """In this process, time the align modes of the port in `tree`; print
    {mode: {"walls": [s, ...], "text": sha256 of the output}}."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import sigmap_tpu_torch
    from sigmap_tpu_torch import cli

    assert os.path.abspath(sigmap_tpu_torch.__file__).startswith(
        tree + os.sep), f"imported {sigmap_tpu_torch.__file__}, not {tree}"
    ref, pore, sig = (os.path.join(work, x)
                      for x in ("ref.fa", "pore.model", "signals"))
    out = {}
    for mode in MODES:
        walls = []
        for _ in range(reps + 1):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(buf):
                rc = cli.main(["--debug-mode", mode, "-r", ref, "-p", pore,
                               "-s", sig])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            assert rc == 0, f"{mode} in {tree} failed ({rc})"
        out[mode] = dict(walls=walls[1:], text=hashlib.sha256(
            buf.getvalue().encode()).hexdigest())
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts of the repo, timed in this order")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", nargs=2, metavar=("TREE", "WORK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(*args.child, args.reps)

    import torch

    if not torch.cuda.is_available():
        sys.exit("tools_torch_align_walls.py: no CUDA card")
    sys.path.insert(0, ROOT)
    from chip_smoke import DEBUG_GENOME, DEBUG_READS, make_workload

    work = os.path.join(ROOT, "build", "align_walls")
    make_workload(work, DEBUG_GENOME, DEBUG_READS)
    runs, texts = [], set()
    for k, tree in enumerate(args.trees):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--reps",
             str(args.reps), "--child", tree, work],
            check=True, capture_output=True, text=True)
        got = json.loads(res.stdout.strip().splitlines()[-1])
        for mode in MODES:
            walls = got[mode]["walls"]
            texts.add((mode, got[mode]["text"]))
            print(f"{k} {tree} {mode}: median {statistics.median(walls):.3f}"
                  f" s (runs {', '.join(f'{w:.3f}' for w in walls)})",
                  flush=True)
        runs.append(dict(tree=tree, **{m: got[m]["walls"] for m in MODES}))
    assert len(texts) == len(MODES), "the checkouts print different text"
    print(json.dumps({"align_walls": runs}))


if __name__ == "__main__":
    main()
