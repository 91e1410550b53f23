"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``
(``csrc/*.cuh`` are headers the sources share).  Libraries are built at
first use into ``joint_tensorf_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the source, the headers and the flags, so a fresh
checkout builds them and an edited source or header is rebuilt.  ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Every wrapper that launches a kernel adds one to ``LAUNCHES[name]`` at the
launch and nowhere else, so a run can show that its main path went through
the kernels; K3's wrapper also notes there the shapes it launched at
(``SCATTER_SHAPES``), so that a run can check K3 at those shapes.
Nothing here runs at import: no compiler, no CUDA context.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# the sources csrc/<stem>.cu; one source may hold several C entry points
SOURCES = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
HEADERS = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
# the kernels whose launches are counted (K1-K5), by C entry point
LAUNCHES = {name: 0 for name in (
    "composite_fwd", "composite_bwd", "scatter_add_rows",
    "binned_plane_scatter", "scatter_add_rows_tiled")}
# K3's launches by shape: (C, n_rows) -> the most rows N one launch
# scattered into n_rows rows of C channels
SCATTER_SHAPES: dict[tuple[int, int], int] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}   # by C symbol


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SCATTER_SHAPES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(stem: str) -> str:
    """The library's path, named by a hash of its source, the headers of
    csrc/ and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [stem + ".cu"] + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_all(stems=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source in parallel.

    Returns {stem: seconds} for the sources compiled in this call (cached
    ones are absent).  Raises with the compiler's output on failure.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for stem in stems:
        out = _lib_path(stem)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, stem + ".cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, errors = {}, []
    for stem, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {stem}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        took[stem] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def kernel(stem: str, symbol: str, argtypes):
    """The ctypes function ``symbol`` of csrc/<stem>.cu, building its
    library if needed.

    ``argtypes`` must name ctypes.c_void_p for every pointer and the
    stream: an undeclared pointer is passed as a 32-bit int and cut."""
    fn = _FNS.get(symbol)
    if fn is None:
        lib = _LIBS.get(stem)
        if lib is None:
            path = _lib_path(stem)
            if not os.path.exists(path):
                build_all([stem])
            lib = _LIBS[stem] = ctypes.CDLL(path)
        fn = _FNS[symbol] = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str):
    """Raise if the C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
