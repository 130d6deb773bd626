"""Build-at-first-use for the port's native pieces, and the launch counters.

Two shared libraries are built into ``build/sigmap_tpu_torch/`` (listed in
``.gitignore``) the first time they are needed, and rebuilt whenever the
hash of their sources or flags changes:

* the Hopper kernels, ``csrc/*.cu`` compiled by ``nvcc`` for ``sm_90a``
  into one library with a plain C interface, loaded with ``ctypes``;
* the host core ``native/core.cc`` (k-d tree, event features, k-mer masks,
  dedup) through its own Makefile, with ``OUT`` pointed into the build
  directory.  ``sigmap_tpu.native`` is then pointed at that library before
  it first loads, so the port never relies on a prebuilt binary.

A build failure raises; nothing falls back.

``LAUNCHES`` counts kernel launches by name.  Each kernel wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
    "-Xcompiler", "-fPIC",
)

# native/Makefile's flags without -fopenmp: core.cc has no OpenMP code, and
# the flag only adds a dependency on the toolchain's libgomp, which a host
# may lack
NATIVE_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17 -Wall"

LAUNCHES = {"peaks": 0, "compress_keep": 0, "sweep": 0, "chain_fused": 0,
            "sdtw": 0}

_kernels = None
_native_ready = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _digest(paths, extra: tuple) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr(extra).encode())
    return h.hexdigest()[:16]


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
    if _kernels is not None:
        return _kernels
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    tag = _digest(srcs, NVCC_FLAGS)
    out = BUILD_DIR / f"libsigmap_kernels_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        # one nvcc per source, all at once, then one link
        objs, procs = [], []
        for s in srcs:
            if s.suffix != ".cu":
                continue
            obj = BUILD_DIR / f"{s.stem}_{tag}.{os.getpid()}.o"
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [(p.communicate()[0], p) for p in procs]
        for text, p in logs:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{text}")
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                            *objs], capture_output=True, text=True)
        for o in objs:
            os.remove(o)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}"
            )
        os.replace(tmp, out)   # a concurrent build never sees half a file
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _kernels = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sig_peaks_launch.restype = I
    lib.sig_peaks_launch.argtypes = [P, P, P, I, I, I, I, F, F, F, P, P]
    lib.sig_compress_keep_launch.restype = I
    lib.sig_compress_keep_launch.argtypes = [P, P, I, I, F, P, P]
    lib.sig_sweep_launch.restype = I
    lib.sig_sweep_launch.argtypes = [
        P, P, I, I, P, P, I, F, I, I, I, P, P, P, P,
    ]
    lib.sig_chain_fused_launch.restype = I
    lib.sig_chain_fused_launch.argtypes = (
        [P] * 9 + [I] * 5 + [F, I, I, I, F, F] + [P] * 12 + [P]
    )
    lib.sig_sdtw_launch.restype = I
    lib.sig_sdtw_launch.argtypes = [P, P, P, P, I, I, I, I, P, P, P, P]


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def native() -> None:
    """Build native/core.cc into the build directory and point
    ``sigmap_tpu.native`` at it; raise if it does not load."""
    global _native_ready
    if _native_ready:
        return
    from sigmap_tpu import native as nat

    if nat._lib is None:
        src = REPO / "native" / "core.cc"
        tag = _digest([src, REPO / "native" / "Makefile"],
                      (NATIVE_CXXFLAGS,))
        out = BUILD_DIR / f"libsigmap_core_{tag}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run(
                ["make", "-s", "-B", "-C", str(REPO / "native"),
                 f"OUT={tmp}", f"CXXFLAGS={NATIVE_CXXFLAGS}"],
                capture_output=True, text=True,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    f"native core build failed:\n{r.stdout}\n{r.stderr}"
                )
            os.replace(tmp, out)
        nat._SO = out
    if not nat.available():
        raise RuntimeError("the native core (native/core.cc) did not load")
    _native_ready = True
