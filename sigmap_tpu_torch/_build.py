"""Build-at-first-use for the port's native pieces, and the launch counters.

Two shared libraries are built into ``build/sigmap_tpu_torch/`` (listed in
``.gitignore``) the first time they are needed, and rebuilt whenever the
hash of their sources or flags changes:

* the Hopper kernels, ``csrc/*.cu`` compiled by ``nvcc`` for ``sm_90a``
  into one library with a plain C interface, loaded with ``ctypes``;
* the host core ``csrc/core.cc`` (k-d tree, event features, k-mer masks,
  dedup) compiled by ``g++``; the port's ``native`` module loads it, so the
  port never relies on a prebuilt binary;
* the rescue search's host side ``csrc/rescue_host.cc``, compiled by ``g++``
  as the core is (``rescue_host``).

A build failure raises; nothing falls back.

``LAUNCHES`` counts kernel launches by name.  Each kernel wrapper adds one
where it launches its kernel (``count_launch``), and nowhere else.  A
launch made while its thread captures a CUDA graph does not run then: it
is counted in the capture's record instead, and the graph adds the record
to ``LAUNCHES`` at each replay (``mapping/graphs.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import uuid
from pathlib import Path

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
BUILD_DIR = REPO / "build" / "sigmap_tpu_torch"
CSRC = PKG / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every kernel reproduces the reference's f32 rounding op by op: no
    # contraction of a*b+c into FMA, IEEE division and square root
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    # and the host code, which rescue_search.cu includes from
    # rescue_host.cc, as the native core (NATIVE_CXXFLAGS)
    "-Xcompiler", "-fPIC", "-Xcompiler", "-ffp-contract=off",
    # each kernel's registers, shared memory, stack and spills (BUILD_LOG)
    "-Xptxas", "-v",
)

# core.cc has no OpenMP code: no -fopenmp, which would only add a dependency
# on the toolchain's libgomp, which a host may lack.  -ffp-contract=off: g++
# otherwise contracts a*b+c into FMA wherever -march=native offers one, and
# how often depends on the host and the compiler, so distances and chain
# scores would round differently from host to host.  Without -ffast-math g++
# does not reassociate, so with contraction off the vector width that
# -march=native picks no longer changes a result: the core rounds op by op,
# as the CUDA kernels do (-fmad=false above).  -pthread: the k-d tree is
# built on std::threads.
NATIVE_CXXFLAGS = ("-O3 -march=native -ffp-contract=off -fPIC -std=c++17 "
                   "-Wall -pthread")

LAUNCHES = {"peaks": 0, "compress_keep": 0, "sweep": 0, "chain_fused": 0,
            "sdtw": 0, "rescue_search": 0}

# compiler output of the kernel library's build by source stem (ptxas -v
# lines), kept beside the library as <library>.log.json
BUILD_LOG: dict = {}

_kernels = None
_rescue_host = None
_native_ready = False
# the first build and load of either library happens once in a process,
# whichever of its threads gets there first (a mapper prepares batches on a
# thread of its own)
_lock = threading.Lock()


# the launches this thread records while it captures a graph (None: it
# captures none)
_capture = threading.local()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: counted in LAUNCHES, or in the record
    of the graph this thread captures."""
    rec = getattr(_capture, "launches", None)
    if rec is None:
        LAUNCHES[name] += 1
    else:
        rec[name] = rec.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """While the block runs, this thread's launches go to the yielded dict
    (kernel name -> launches) and not to LAUNCHES."""
    prev = getattr(_capture, "launches", None)
    _capture.launches = rec = {}
    try:
        yield rec
    finally:
        _capture.launches = prev


def add_launches(rec: dict) -> None:
    """A replayed graph's launches (``recording_launches``) into LAUNCHES."""
    for k, n in rec.items():
        LAUNCHES[k] += n


def _digest(paths, extra: tuple) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr(extra).encode())
    return h.hexdigest()[:16]


def _tmp_suffix() -> str:
    """A name part of this call's temporary files: no other process, thread
    or call writes to them."""
    return f"{os.getpid()}.{uuid.uuid4().hex[:12]}"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library, built on first call."""
    global _kernels
    if _kernels is None:
        with _lock:
            if _kernels is None:
                _kernels = _load_kernels()
    return _kernels


def _load_kernels() -> ctypes.CDLL:
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    tag = _digest(srcs + [CSRC / "rescue_host.cc"], NVCC_FLAGS)
    out = BUILD_DIR / f"libsigmap_kernels_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sfx = _tmp_suffix()
        tmp = out.with_suffix(f".{sfx}.tmp")
        # one nvcc per source, all at once, then one link
        cus = [s for s in srcs if s.suffix == ".cu"]
        objs = [str(BUILD_DIR / f"{s.stem}_{tag}.{sfx}.o") for s in cus]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, obj in zip(cus, objs)]
        logs = [(p.communicate()[0], p) for p in procs]
        for s, (text, p) in zip(cus, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{text}")
        log = {s.stem: text for s, (text, _) in zip(cus, logs)}
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                            *objs], capture_output=True, text=True)
        for o in objs:
            os.remove(o)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}"
            )
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(json.dumps(log))
        os.replace(log_tmp, out.with_suffix(".log.json"))
        os.replace(tmp, out)   # a concurrent build never sees half a file
    log_path = out.with_suffix(".log.json")
    if log_path.exists():
        BUILD_LOG.update(json.loads(log_path.read_text()))
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sig_peaks_launch.restype = I
    lib.sig_peaks_launch.argtypes = [P, P, P, I, I, I, I, F, F, F, P, P]
    lib.sig_compress_keep_launch.restype = I
    lib.sig_compress_keep_launch.argtypes = [P, P, I, I, F, P, P]
    lib.sig_sweep_launch.restype = I
    lib.sig_sweep_launch.argtypes = [
        P, P, I, I, P, P, I, F, I, I, I, P, P, P, P, P,
    ]
    lib.sig_chain_fused_launch.restype = I
    lib.sig_chain_fused_launch.argtypes = (
        [P] * 9 + [I] * 6 + [F, I, I, I, F, F] + [P] * 11 + [P]
    )
    lib.sig_chain_fused_smem.restype = ctypes.c_longlong
    lib.sig_chain_fused_smem.argtypes = [I, I, I, I, I]
    lib.sig_sdtw_launch.restype = I
    lib.sig_sdtw_launch.argtypes = [P, P, P, P] + [I] * 6 + [P, P, P, P]
    lib.sig_rescue_search_launch.restype = I
    lib.sig_rescue_search_launch.argtypes = [P, P, I, I, P, I, F, I, I, I,
                                             P, P]
    L, D = ctypes.c_int64, ctypes.c_double
    lib.sig_rescue_search_card.restype = L
    lib.sig_rescue_search_card.argtypes = (
        [I, P, I, I, P, P, P, P, I, D, D, I, L, P, L, P, L, I, P, P, F, I,
         P, P, P, P, L] + [P] * 7)


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def native_library(src: Path = CSRC / "core.cc",
                   build_dir: Path = BUILD_DIR) -> Path:
    """`src` (csrc/core.cc) compiled with NATIVE_CXXFLAGS into `build_dir`
    (once per source and flags hash); returns the library's path."""
    out = build_dir / f"libsigmap_core_{_digest([src], (NATIVE_CXXFLAGS,))}.so"
    if not out.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{_tmp_suffix()}.tmp")
        r = subprocess.run(["g++", *NATIVE_CXXFLAGS.split(), "-shared", "-o",
                            str(tmp), str(src)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"native core build failed:\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, out)
    return out


def rescue_host() -> ctypes.CDLL:
    """``csrc/rescue_host.cc`` as a library, built on first call."""
    global _rescue_host
    if _rescue_host is None:
        with _lock:
            if _rescue_host is None:
                lib = ctypes.CDLL(str(native_library(CSRC / "rescue_host.cc")))
                P, I, L, F = (ctypes.c_void_p, ctypes.c_int32,
                              ctypes.c_int64, ctypes.c_float)
                D = ctypes.c_double
                lib.sig_rescue_table.restype = L
                lib.sig_rescue_table.argtypes = [
                    P, I, I, P, P, P, P, I, D, D, I, L, P, L, L, I, P, P]
                lib.sig_rescue_exact.restype = L
                lib.sig_rescue_exact.argtypes = [
                    P, I, L, P, P, P, P, I, F, I, P, P, P]
                _rescue_host = lib
    return _rescue_host


def native() -> None:
    """Build csrc/core.cc, point the port's ``native`` module at it, and
    raise if it does not load."""
    global _native_ready
    if _native_ready:
        return
    from . import native as nat

    with _lock:
        if _native_ready:
            return
        if nat._lib is None:
            nat._SO = native_library()
        if not nat.available():
            raise RuntimeError("the native core (csrc/core.cc) did not load")
        _native_ready = True
