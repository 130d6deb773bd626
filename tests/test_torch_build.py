"""The port's build-at-first-use (sigmap_tpu_torch/_build.py) from several
threads of one process at once: a mapper prepares batches on a thread of its
own, so two threads can reach the first build together.  The native core is
built with g++ here; the CUDA library needs nvcc, so its lock is tested with
a stand-in for the build."""

import ctypes
import threading
import time

from sigmap_tpu_torch import _build
from sigmap_tpu_torch import native as nat

THREADS = 6


def _all_at_once(fn, n=THREADS, timeout=120):
    """fn() on n threads released together; returns their results and
    errors."""
    gate = threading.Barrier(n)
    results, errors = [], []

    def run():
        gate.wait()
        try:
            results.append(fn())
        except Exception as e:  # noqa: BLE001 - handed to the test
            errors.append(e)

    threads = [threading.Thread(target=run, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_native_builds_and_loads_once(tmp_path, monkeypatch):
    """_build.native() from several threads at once: one build, one load,
    no error.  The build is held back a little so that the other threads
    arrive while it runs."""
    builds, loads = [], []
    build, load = _build.native_library, ctypes.CDLL

    def slow_build():
        builds.append(1)
        time.sleep(0.2)
        return build(_build.CSRC / "core.cc", tmp_path)

    def counted_load(*a, **k):
        loads.append(a[0])
        return load(*a, **k)

    monkeypatch.setattr(_build, "native_library", slow_build)
    monkeypatch.setattr(_build, "_native_ready", False)
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_SO", None)
    monkeypatch.setattr(ctypes, "CDLL", counted_load)
    _, errors = _all_at_once(_build.native)
    assert errors == []
    assert len(builds) == 1 and len(loads) == 1
    assert loads[0].startswith(str(tmp_path))
    assert _build._native_ready and nat.available()


def test_native_library_builds_side_by_side(tmp_path):
    """Several builds of the native core into one directory at once (as two
    processes may run them): each writes its own temporary file, and all
    return the one library, which loads."""
    results, errors = _all_at_once(
        lambda: _build.native_library(_build.CSRC / "core.cc", tmp_path),
        n=3)
    assert errors == []
    assert len(set(results)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [results[0].name]
    ctypes.CDLL(str(results[0]))


def test_kernels_load_once(monkeypatch):
    """_build.kernels() from several threads at once builds and loads the
    CUDA library once (a stand-in for the nvcc build and load)."""
    calls = []
    lib = object()

    def slow_load():
        calls.append(1)
        time.sleep(0.2)
        return lib

    monkeypatch.setattr(_build, "_kernels", None)
    monkeypatch.setattr(_build, "_load_kernels", slow_load)
    results, errors = _all_at_once(_build.kernels)
    assert errors == []
    assert len(calls) == 1
    assert results == [lib] * THREADS

