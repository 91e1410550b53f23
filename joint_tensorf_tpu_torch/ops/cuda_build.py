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
``launch`` calls an entry point on the current stream and counts it;
``check_factor_args`` and ``ptrs`` shape the arguments that the factor
samples K6 and K7 share.  Nothing here runs at import: no compiler, no
CUDA context.
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
# the kernels whose launches are counted (K1-K7), by C entry point
LAUNCHES = {name: 0 for name in (
    "composite_fwd", "composite_bwd", "scatter_add_rows",
    "binned_plane_scatter", "scatter_add_rows_tiled", "density_sample_fwd",
    "density_sample_bwd", "app_sample_fwd", "app_sample_bwd")}
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


def launch(stem: str, symbol: str, argtypes, *args, dev):
    """Call the C entry point ``symbol`` of csrc/<stem>.cu (kernel()) with
    ``args`` and the current stream of CUDA device ``dev``, count the
    launch in LAUNCHES and raise if it reported an error (check())."""
    import torch

    fn = kernel(stem, symbol, argtypes)
    index = dev.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    LAUNCHES[symbol] += 1
    check(err, symbol)


# The factor samples' (K6, K7) arguments: three device pointers and the 21
# dims go as host arrays.
PTRS = ctypes.c_void_p * 3
DIMS = ctypes.c_int * 21
VOIDP = ctypes.c_void_p
PTR_ARRAY = ctypes.POINTER(ctypes.c_void_p)
INT_ARRAY = ctypes.POINTER(ctypes.c_int)


def ptrs(ts) -> "ctypes.Array":
    """Three tensors' device pointers as a host array, 0 for None."""
    return PTRS(*(0 if t is None else t.data_ptr() for t in ts))


def check_factor_args(name, planes, lines, coords, axes, live=None, g=None,
                      g_width=None):
    """The 21 dims (H, W, D, R and the three coordinates' indices an axis)
    and N of a factor sample's arguments, after the checks: float32,
    contiguous and on one CUDA device; three planes [H, W, R], lines [D, R]
    and coordinates [N]; live a [N] bool or None; the cotangent g [N]
    (g_width None) or [N, g_width], or None."""
    import torch

    dev = coords[0].device
    tensors = list(planes) + list(lines) + list(coords) + (
        [] if g is None else [g])
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    N = coords[0].shape[0]
    if len(planes) != 3 or len(lines) != 3 or len(coords) != 3 or any(
            c.shape != (N,) for c in coords):
        raise ValueError(f"{name}: want three planes, lines and [N] "
                         f"coordinates")
    g_shape = (N,) if g_width is None else (N, g_width)
    if g is not None and g.shape != g_shape:
        raise ValueError(f"{name}: want the cotangent {list(g_shape)}, got "
                         f"{list(g.shape)}")
    if live is not None and (live.dtype != torch.bool or live.shape != (N,)
                             or live.device != dev
                             or not live.is_contiguous()):
        raise ValueError(f"{name}: live must be a contiguous [N] bool "
                         f"tensor on the coordinates' device")
    dims = []
    for plane, line, ax in zip(planes, lines, axes):
        if plane.dim() != 3 or line.dim() != 2 or \
                line.shape[1] != plane.shape[2]:
            raise ValueError(f"{name}: bad factor shapes "
                             f"{tuple(plane.shape)} / {tuple(line.shape)}")
        if sorted(ax) != [0, 1, 2]:
            raise ValueError(f"{name}: bad axes {axes}")
        H, W, R = plane.shape
        dims += [H, W, line.shape[0], R, *ax]
    return dims, N


def check(err: int, name: str):
    """Raise if the C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
