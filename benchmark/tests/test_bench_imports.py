"""Nothing under benchmark/ imports JAX or the JAX package, the reference
imports nothing of the port, and nothing reads the JAX package's
benchmark files."""

import ast
import os

from benchmark import workload

BENCH_DIR = os.path.join(workload.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "sigmap_tpu"}


def python_files(top=BENCH_DIR):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every module a file imports (relative imports
    are the benchmark's own)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"):
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]


def test_no_jax_anywhere_in_the_benchmark():
    seen = {}
    for path in python_files():
        for name in imported(path):
            seen.setdefault(name, []).append(path)
    bad = FORBIDDEN & set(seen)
    assert not bad, {k: seen[k] for k in bad}
    # the port's name begins with the JAX package's: compared whole
    assert "sigmap_tpu_torch" in seen


def test_the_reference_imports_nothing_of_the_port():
    for path in python_files(os.path.join(BENCH_DIR, "reference")):
        names = set(imported(path))
        assert not names & (FORBIDDEN | {"sigmap_tpu_torch"}), path


def test_nothing_reads_the_jax_packages_benchmark_files():
    for path in python_files():
        text = open(path).read()
        for word in ("bench.py", "BENCH_r", "MULTICHIP_", "SCALING.json",
                     "BASELINE."):
            assert word not in text or path.endswith(
                "test_bench_imports.py"), (path, word)
