"""Package layout of sigmap_tpu_torch: it never imports JAX, h5py or
anything of the JAX package ``sigmap_tpu`` (nor does chip_smoke.py), and
its entry points that need a GPU fail without one instead of running
something else."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "sigmap_tpu_torch", "sigmap_tpu_torch._build", "sigmap_tpu_torch.cli",
    "sigmap_tpu_torch.oracle", "sigmap_tpu_torch.signal.events",
    "sigmap_tpu_torch.signal.events_kernels",
    "sigmap_tpu_torch.ops.sweep_kernel", "sigmap_tpu_torch.ops.chain_fused",
    "sigmap_tpu_torch.mapping.sweep_search",
    "sigmap_tpu_torch.mapping.turbo", "sigmap_tpu_torch.mapping.graphs",
    "sigmap_tpu_torch.mapping.records", "sigmap_tpu_torch.mapping.spans",
    "sigmap_tpu_torch.ops.sdtw_kernel", "sigmap_tpu_torch.signal.events_ref",
    "sigmap_tpu_torch.debug_modes", "sigmap_tpu_torch.mapping.seeding",
    "sigmap_tpu_torch.mapping.driver", "sigmap_tpu_torch.config",
    "sigmap_tpu_torch.utils", "sigmap_tpu_torch.native",
    "sigmap_tpu_torch.synth", "sigmap_tpu_torch.io.fasta",
    "sigmap_tpu_torch.io.paf", "sigmap_tpu_torch.io.pore_model",
    "sigmap_tpu_torch.io.signals", "sigmap_tpu_torch.io.slow5",
    "sigmap_tpu_torch.io.fast5", "sigmap_tpu_torch.index.build",
    "sigmap_tpu_torch.index.sweep", "sigmap_tpu_torch.mapping.chain",
    "sigmap_tpu_torch.ops.cwt", "sigmap_tpu_torch.evaluate",
    "sigmap_tpu_torch.ops.fastdtw", "sigmap_tpu_torch.parallel",
    "sigmap_tpu_torch.parallel.turbo_shard",
    "sigmap_tpu_torch.parallel.multihost",
    "sigmap_tpu_torch.ops.rescue_search", "sigmap_tpu_torch.mapping.rescue",
    "sigmap_tpu_torch.builders",
]

BLOCKER = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "h5py", "sigmap_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, Block())
for m in sys.argv[1:]:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok", len(sys.argv) - 1)
"""


# tests/test_torch_gpu.py runs where the GPU is and JAX is not, and so does
# the sharded mapper's worker (chip_smoke.py phase 11): they and the
# fixture module import nothing of the JAX package either
GPU_TESTS = ["test_torch_gpu", "_torch_gpu_util", "_torch_shard_worker"]


def _run(code, *args):
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_imports_without_jax():
    r = _run(BLOCKER, *MODULES, *GPU_TESTS)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"ok {len(MODULES) + len(GPU_TESTS)}"


def test_modules_list_is_complete():
    pkg = os.path.join(ROOT, "sigmap_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "__main__.py":
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                found.add(mod[: -len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    subpkgs = {"sigmap_tpu_torch.signal", "sigmap_tpu_torch.ops",
               "sigmap_tpu_torch.mapping", "sigmap_tpu_torch.io",
               "sigmap_tpu_torch.index"}
    assert found - subpkgs == set(MODULES)


def _import_roots(path):
    """The top-level names of every import statement anywhere in `path`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py imports sigmap_tpu_torch, torch, numpy and the stdlib:
    no import statement anywhere in it names sigmap_tpu or jax."""
    roots = _import_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert "sigmap_tpu_torch" in roots
    assert not roots & {"sigmap_tpu", "jax", "jaxlib", "h5py"}, roots


def test_align_walls_tool_imports_nothing_of_the_jax_package():
    """tools_torch_align_walls.py runs on the card's machine (no JAX): it
    imports the port, chip_smoke, torch and the stdlib only."""
    roots = _import_roots(os.path.join(ROOT, "tools_torch_align_walls.py"))
    assert {"sigmap_tpu_torch", "chip_smoke"} <= roots
    assert not roots & {"sigmap_tpu", "jax", "jaxlib", "h5py"}, roots


@pytest.mark.parametrize("module", GPU_TESTS)
def test_gpu_tests_import_nothing_of_the_jax_package(module):
    """No import statement of tests/test_torch_gpu.py or its fixture module,
    not even inside a function, names sigmap_tpu, jax, jaxlib or h5py."""
    roots = _import_roots(os.path.join(ROOT, "tests", module + ".py"))
    assert "sigmap_tpu_torch" in roots
    assert not roots & {"sigmap_tpu", "jax", "jaxlib", "h5py"}, roots


def test_no_other_torch_test_file_has_a_gpu_mark():
    """Every test that needs the GPU lives in tests/test_torch_gpu.py, the
    one file that runs on the card; the others import JAX."""
    def marks_gpu(path):     # any `<x>.mark.gpu` in the code
        with open(path) as f:
            tree = ast.parse(f.read())
        return any(isinstance(n, ast.Attribute) and n.attr == "gpu"
                   and isinstance(n.value, ast.Attribute)
                   and n.value.attr == "mark" for n in ast.walk(tree))

    tests = os.path.join(ROOT, "tests")
    files = [f for f in os.listdir(tests)
             if f.startswith("test_torch_") and f.endswith(".py")]
    assert marks_gpu(os.path.join(tests, "test_torch_gpu.py"))
    assert [f for f in sorted(files) if f != "test_torch_gpu.py"
            and marks_gpu(os.path.join(tests, f))] == []


@pytest.mark.parametrize("flags", [
    ["-m"], ["-m", "--engine", "exact"], ["-m", "--batch-mode"],
    ["--debug-mode", "dtw-align"], ["--debug-mode", "cwt-align"],
])
def test_cli_map_needs_a_gpu(flags, tmp_path, monkeypatch):
    import torch

    from sigmap_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["-r", "x.fa", "-p", "x.model", "-x", "idx", "-s",
            str(tmp_path), "-o", str(tmp_path / "o.paf"), *flags]
    assert main(args) != 0
    assert list(tmp_path.iterdir()) == []


def test_chip_smoke_device_busy_counts_overlap_once(tmp_path):
    """The smoke's device time is the union of kernel/memcpy/memset spans;
    host ops and profiler bookkeeping are not device time."""
    import json

    sys.path.insert(0, ROOT)
    from chip_smoke import device_busy

    ev = [dict(ph="X", cat="kernel", name="k", ts=0, dur=1000),
          dict(ph="X", cat="kernel", name="k", ts=500, dur=1000),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=3000,
               dur=500),
          dict(ph="X", cat="cpu_op", name="aten::to", ts=0, dur=9000),
          dict(ph="X", cat="gpu_user_annotation", name="a", ts=0, dur=9000),
          dict(ph="i", cat="kernel", name="k", ts=100)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    busy, by_name = device_busy(str(path))
    assert busy == 2.0
    assert by_name == {"k": (2.0, 2), "Memcpy HtoD": (0.5, 1)}


def test_chip_smoke_pass_waits():
    """Phase 10's waits come from the mapper's own stamps: the head up to
    the first batch's rounds, the gaps between batches' rounds, each
    batch's rounds, and the rescue wait, in ms."""
    sys.path.insert(0, ROOT)
    from chip_smoke import pass_waits

    w = pass_waits(dict(start=1.0, rounds=[(1.25, 1.5), (1.5625, 2.0)],
                        rescues=(2.0, 2.125)))
    assert w == dict(head_ms=250.0, between_ms=[62.5],
                     rounds_ms=[250.0, 437.5], rescue_tail_ms=125.0)


def test_chip_smoke_round_host_ms():
    """Phases 5 and 10 read each round's host time from the mapper's own
    stamps: the rounds, and the median ms until a round's work was sent
    and until its host signal came back."""
    sys.path.insert(0, ROOT)
    from chip_smoke import round_host_ms

    w = round_host_ms(dict(round_host=[(0.001, 0.004), (0.003, 0.005),
                                       (0.002, 0.0045)]))
    assert w == dict(rounds=3, sent_ms=2.0, back_ms=4.5)


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """chip_smoke.py alone (no package beside it) exits non-zero and prints
    no result line, even where a CUDA device is visible: the device check is
    patched to pass, so the run reaches the package import."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    (tmp_path / "run.py").write_text(
        "import runpy, torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "run.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "No module named 'sigmap_tpu_torch'" in r.stderr, r.stderr


def test_chip_smoke_host_gaps_names_the_ops_in_each_gap(tmp_path):
    """The smoke's gap list: gaps between merged device intervals and the
    stretches before the first and after the last one, longest first, each
    with the host ops that ran inside it and their share."""
    import json

    sys.path.insert(0, ROOT)
    from chip_smoke import host_gaps

    ev = [dict(ph="X", cat="cpu_op", name="aten::empty", ts=-40, dur=30),
          dict(ph="X", cat="kernel", name="k1", ts=0, dur=100),
          dict(ph="X", cat="kernel", name="k2", ts=50, dur=100),   # overlaps
          dict(ph="X", cat="gpu_memcpy", name="copy", ts=1150, dur=50),
          dict(ph="X", cat="kernel", name="k3", ts=1400, dur=10),
          dict(ph="X", cat="cpu_op", name="aten::sort", ts=100, dur=550),
          dict(ph="X", cat="cpu_op", name="aten::nonzero", ts=700, dur=250),
          dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=900,
               dur=100),
          dict(ph="X", cat="cuda_runtime", name="cudaDeviceSynchronize",
               ts=2000, dur=10),
          dict(ph="X", cat="Trace", name="PyTorch Profiler (0)", ts=-100,
               dur=2200)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    got = host_gaps(str(path), top=3)
    assert got["n_gaps"] == 4
    assert got["gap_ms"] == pytest.approx(0.1 + 1.0 + 0.2 + 0.69)
    assert got["host_ops"][:2] == [("aten::sort", 0.5),
                                   ("aten::nonzero", 0.25)]
    gaps = got["longest"]
    assert [g["gap_ms"] for g in gaps] == [1.0, 0.69, 0.2]
    g = gaps[0]                    # device idle from 150 to 1150
    assert (g["after"], g["before"]) == ("k2", "copy")
    assert g["host_ops"] == [("aten::sort", 0.5), ("aten::nonzero", 0.25),
                             ("cudaMemcpyAsync", 0.1)]
    assert g["host_op_share"] == pytest.approx(0.8)   # 150-650 and 700-1000
    g = gaps[1]                    # after the last device interval
    assert (g["after"], g["before"]) == ("k3", "(end of the pass)")
    assert g["host_ops"] == [("cudaDeviceSynchronize", 0.01)]
    assert gaps[2]["host_ops"] == [] and gaps[2]["host_op_share"] == 0.0


def _stream_trace(tmp_path, side_stream=3, close_heads=False, blocks=1):
    """A chrome trace of three batches: the side stream's heads (a copy,
    B1, B2, glue) against the main stream's rounds (B3, B4, glue).  With
    close_heads, batch 1's head follows batch 0's at once and its glue
    comes long after its B2, so the stream's two longest gaps both lie
    between batch 1's B1 and batch 2's.  With blocks=2 each head's B1 is
    two kernels back to back (a head of two row blocks)."""
    import json

    def k(name, ts, end, stream, cat="kernel"):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=end - ts,
                    args=dict(stream=stream))

    s, m = side_stream, 7
    ev = [k("void sweep_kernel<6>(float const*)", 0, 100, m),
          k("void chain_fused_kernel<false>(int const*)", 150, 160, m),
          k("void sweep_kernel<6>(float const*)", 300, 400, m),
          k("elementwise_kernel", 420, 450, m),
          k("void chain_fused_kernel<false>(int const*)", 500, 510, m),
          k("Memcpy DtoH", 520, 530, m, "gpu_memcpy"),
          # batch 0: before any round
          k("Memcpy HtoD", -50, -40, s, "gpu_memcpy"),
          k("peaks_kernel(float const*)", -30, -20, s),
          k("compress_keep_kernel(float const*)", -15, -10, s),
          # batch 1: during the first round's B3
          *([k("Memcpy HtoD", -4, 0, s, "gpu_memcpy"),
             k("peaks_kernel(float const*)", 5, 10, s),
             k("compress_keep_kernel(float const*)", 12, 14, s),
             k("scatter_kernel", 200, 205, s)] if close_heads else
            [k("Memcpy HtoD", 50, 60, s, "gpu_memcpy"),
             k("peaks_kernel(float const*)", 70, 75, s),
             k("compress_keep_kernel(float const*)", 80, 82, s),
             k("scatter_kernel", 85, 88, s)]),
          # batch 2: B1 under B3, B2 under a glue kernel
          k("Memcpy HtoD", 380, 390, s, "gpu_memcpy"),
          k("peaks_kernel(float const*)", 395, 398, s),
          k("compress_keep_kernel(float const*)", 430, 440, s),
          dict(ph="X", cat="cpu_op", name="aten::add", ts=0, dur=900),
          dict(ph="i", cat="kernel", name="peaks_kernel", ts=5)]
    if blocks == 2:
        ev = [half for e in ev for half in (
            [dict(e, dur=e["dur"] / 2),
             dict(e, ts=e["ts"] + e["dur"] / 2, dur=e["dur"] / 2)]
            if e["ph"] == "X" and e["name"].startswith("peaks") else [e])]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


@pytest.mark.parametrize("close_heads,want", [
    (False, [(0.025, 0.0, 0.0), (0.020, 0.020, 0.007),
             (0.023, 0.023, 0.003)]),
    # the cut between batches 1 and 2 falls at the longest gap between
    # their B1s, before batch 1's late glue
    (True, [(0.025, 0.0, 0.0), (0.011, 0.007, 0.007),
            (0.028, 0.023, 0.003)]),
])
def test_chip_smoke_stream_overlap_per_batch(tmp_path, close_heads, want):
    """Phase 10's measure: the side stream's bursts, one B1 each, and the
    time each ran at once with the main stream's work, and its B1/B2 with
    B3/B4 alone."""
    sys.path.insert(0, ROOT)
    from chip_smoke import stream_overlap

    got = stream_overlap(_stream_trace(tmp_path, close_heads=close_heads),
                         ("peaks_kernel", "compress_keep_kernel"),
                         ("sweep_kernel", "chain_fused_kernel"), 3)
    assert (got["side_stream"], got["main_stream"]) == (3, 7)
    for b, (side, both, named) in zip(got["per_batch"], want):
        assert b["side_ms"] == pytest.approx(side)
        assert b["overlap_ms"] == pytest.approx(both)
        assert b["named_overlap_ms"] == pytest.approx(named)
        assert b["first_kernels"] == 1


@pytest.mark.parametrize("close_heads", [False, True])
def test_chip_smoke_stream_overlap_two_blocks_a_batch(tmp_path,
                                                      close_heads):
    """A head of two row blocks runs two B1 kernels: the bursts are cut
    between one batch's last B1 and the next batch's first, and measure
    what they measure with one B1 a batch."""
    sys.path.insert(0, ROOT)
    from chip_smoke import stream_overlap

    names = (("peaks_kernel", "compress_keep_kernel"),
             ("sweep_kernel", "chain_fused_kernel"))
    want = stream_overlap(_stream_trace(tmp_path, close_heads=close_heads),
                          *names, 3)
    got = stream_overlap(_stream_trace(tmp_path, close_heads=close_heads,
                                       blocks=2), *names, 3, 2)
    for g, w in zip(got["per_batch"], want["per_batch"]):
        assert g["first_kernels"] == 2
        for k in ("side_ms", "overlap_ms", "named_overlap_ms"):
            assert g[k] == pytest.approx(w[k])
    with pytest.raises(AssertionError, match="not one a batch: 6 peaks"):
        stream_overlap(_stream_trace(tmp_path, blocks=2), *names, 3)


def test_chip_smoke_stream_overlap_fails_on_one_stream(tmp_path):
    """When B1 ran on the main stream, the overlap is not there."""
    sys.path.insert(0, ROOT)
    from chip_smoke import stream_overlap

    with pytest.raises(AssertionError, match="overlap is not there"):
        stream_overlap(_stream_trace(tmp_path, side_stream=7),
                       ("peaks_kernel",), ("sweep_kernel",), 3)


def test_chip_smoke_stream_overlap_needs_one_b1_a_batch(tmp_path):
    """A side stream that ran another number of B1 kernels than there were
    batches fails the measure."""
    sys.path.insert(0, ROOT)
    from chip_smoke import stream_overlap

    with pytest.raises(AssertionError, match="not one a batch: 3 peaks"):
        stream_overlap(_stream_trace(tmp_path), ("peaks_kernel",),
                       ("sweep_kernel",), 4)


@pytest.mark.parametrize("kb", [1, 4, 8])
def test_chip_smoke_chain_work_counts_filled_slots(kb):
    """chain_work charges every test against the filled part of the ring
    the refusal's operations, and a whole test's only where the slot holds
    the anchor's g and a target in its window: a direct count, row by row
    against a ring kept as the DP keeps it, gives the same numbers."""
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import (CHAIN_OPS_PER_REFUSAL, CHAIN_OPS_PER_SLOT,
                            chain_adversarial, chain_counts, chain_work)

    args, kw = chain_adversarial(0)
    a_t, a_g, ring = args[0], args[3], kw["ring"]
    CARRY = args[4].shape[0]
    A, B = a_g.shape
    tgap = 40            # narrower than the reads' spans: both outcomes occur
    tests = pairs = n_valid = longest = 0
    for b in range(B):
        slots = [None] * ring          # (t, g) by physical slot
        cur = 0
        for i in range(CARRY):
            if a_g[i, b] >= 0:
                slots[cur % ring] = (int(a_t[i, b]), int(a_g[i, b]))
                cur += 1
        mine = 0
        for i0 in range(CARRY, A, kb):
            rows = [i for i in range(i0, i0 + kb) if a_g[i, b] >= 0]
            filled = [s for s in slots if s is not None]
            assert len(filled) == min(cur, ring)
            for i in rows:               # the ring at the block's start
                tests += len(filled)
                pairs += sum(g == a_g[i, b] and 0 < a_t[i, b] - t <= tgap
                             for t, g in filled)
            for i in rows:
                slots[cur % ring] = (int(a_t[i, b]), int(a_g[i, b]))
                cur += 1
            mine += len(rows)
        n_valid += mine
        longest = max(longest, mine)
    got = chain_counts(torch.from_numpy(a_t), torch.from_numpy(a_g), CARRY,
                       ring, kb, tgap)
    assert got == dict(valid_new_anchors=n_valid,
                       longest_read_valid_anchors=longest, slot_tests=tests,
                       window_pairs=pairs,
                       slot_tests_all_slots=n_valid * ring)
    assert 0 < pairs < tests < n_valid * ring
    ops, nbytes = chain_work(got, A, B, CARRY, ring)
    assert ops == (tests * CHAIN_OPS_PER_REFUSAL
                   + pairs * (CHAIN_OPS_PER_SLOT - CHAIN_OPS_PER_REFUSAL))
    assert nbytes == 4 * (4 * A * B + 5 * CARRY * B + 8 * ring * B + 16 * B)


def test_chip_smoke_last_line_is_the_result_object():
    """chip_smoke.py parses, and the last statement of its main() prints
    exactly {"ok": true, "device": {"platform": "gpu", "kind": <device
    name>, "count": <device count>}}."""
    import ast as _ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    main = next(n for n in _ast.parse(src).body
                if isinstance(n, _ast.FunctionDef) and n.name == "main")
    last = _ast.get_source_segment(src, main.body[-1])
    assert " ".join(last.split()) == (
        'print(json.dumps({"ok": True, "device": { "platform": "gpu", '
        '"kind": torch.cuda.get_device_name(0), '
        '"count": torch.cuda.device_count()}}))')
