"""The summed plane x line density sample on the card: kernel K6's
wrappers (csrc/density_sample.cu).

    density_sample_fwd_cuda(planes, lines, coords, axes, live) -> [N]
        sum over the three axes a and the R channels of
        plane_a(u, v) * line_a(w), u, v, w = coords[axes[a][0..2]];
        0 where ``live`` is False (None: every slot live)
    density_sample_bwd_cuda(..., g, need) -> the gradients asked for

Each launches once and adds one to ``cuda_build.LAUNCHES`` under its C
entry point's name.  The autograd Function around them and the plain
version (any CPU tensor) are ops/sampling.py's SamplePlaneLineProdSum and
sample_planeline_prod_sum_plain.  Float32 only: the wrappers raise on any
other type, on tensors off one CUDA device, and on bad shapes.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# three device pointers and the 21 dims go as host arrays
_PTRS = ctypes.c_void_p * 3
_DIMS = ctypes.c_int * 21
_P = ctypes.c_void_p
_A = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.POINTER(ctypes.c_int)
_FWD_ARGTYPES = [_A, _A, _I, _A, _P, _P, ctypes.c_longlong, _P]
_BWD_ARGTYPES = [_A, _A, _I, _A, _P, _P, _A, _A, _A, ctypes.c_longlong, _P]


def _check(name, planes, lines, coords, axes, live, g=None):
    """The 21 dims (H, W, D, R and the three coordinates' indices an
    axis) and N, after the checks."""
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
            c.shape != (N,) for c in coords) or (
            g is not None and g.shape != (N,)):
        raise ValueError(f"{name}: want three planes, lines and [N] "
                         f"coordinates")
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


def _ptrs(ts):
    return _PTRS(*(0 if t is None else t.data_ptr() for t in ts))


def _launch(symbol, *args, dev):
    fn = cuda_build.kernel(
        "density_sample", symbol,
        _FWD_ARGTYPES if symbol == "density_sample_fwd" else _BWD_ARGTYPES)
    index = dev.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    cuda_build.LAUNCHES[symbol] += 1
    cuda_build.check(err, symbol)


def density_sample_fwd_cuda(planes, lines, coords, axes, live=None):
    """Launch K6's forward: planes [H_a, W_a, R_a], lines [D_a, R_a] and
    coords (x, y, z) [N] float32 contiguous on one CUDA device; axes[a] =
    (u, v, w), the coordinates plane a reads along W and H and line a
    along D; live [N] bool or None -> feature [N] float32."""
    dims, N = _check("density_sample_fwd_cuda", planes, lines, coords,
                     axes, live)
    out = torch.empty((N,), dtype=torch.float32, device=coords[0].device)
    _launch("density_sample_fwd", _ptrs(planes), _ptrs(lines), _DIMS(*dims),
            _ptrs(coords), None if live is None else live.data_ptr(),
            out.data_ptr(), N, dev=out.device)
    return out


def density_sample_bwd_cuda(planes, lines, coords, axes, live, g,
                            need=(True,) * 9):
    """Launch K6's backward with the feature's cotangent g [N]: returns
    (d_planes, d_lines, d_coords), three each, None where ``need`` (nine
    flags: the planes, the lines, the coordinates) asks for none.  The
    factor gradients are the planes' and lines' shapes, zeroed and added
    into by the kernel; the coordinates' are written at every slot (0 at
    the dead ones)."""
    dims, N = _check("density_sample_bwd_cuda", planes, lines, coords, axes,
                     live, g)
    dev = coords[0].device

    def new(t, want):
        return torch.empty_like(t) if want else None

    d_planes = [new(p, w) for p, w in zip(planes, need[0:3])]
    d_lines = [new(ln, w) for ln, w in zip(lines, need[3:6])]
    d_coords = [new(c, w) for c, w in zip(coords, need[6:9])]
    _launch("density_sample_bwd", _ptrs(planes), _ptrs(lines), _DIMS(*dims),
            _ptrs(coords), None if live is None else live.data_ptr(),
            g.data_ptr(), _ptrs(d_planes), _ptrs(d_lines), _ptrs(d_coords),
            N, dev=dev)
    return d_planes, d_lines, d_coords
