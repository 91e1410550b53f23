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
from .cuda_build import DIMS, check_factor_args, ptrs

_P, _A, _I = cuda_build.VOIDP, cuda_build.PTR_ARRAY, cuda_build.INT_ARRAY
_FWD_ARGTYPES = [_A, _A, _I, _A, _P, _P, ctypes.c_longlong, _P]
_BWD_ARGTYPES = [_A, _A, _I, _A, _P, _P, _A, _A, _A, ctypes.c_longlong, _P]


def density_sample_fwd_cuda(planes, lines, coords, axes, live=None):
    """Launch K6's forward: planes [H_a, W_a, R_a], lines [D_a, R_a] and
    coords (x, y, z) [N] float32 contiguous on one CUDA device; axes[a] =
    (u, v, w), the coordinates plane a reads along W and H and line a
    along D; live [N] bool or None -> feature [N] float32."""
    dims, N = check_factor_args(
        "density_sample_fwd_cuda", planes, lines, coords, axes, live)
    out = torch.empty((N,), dtype=torch.float32, device=coords[0].device)
    cuda_build.launch("density_sample", "density_sample_fwd", _FWD_ARGTYPES,
                      ptrs(planes), ptrs(lines), DIMS(*dims), ptrs(coords),
                      None if live is None else live.data_ptr(),
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
    dims, N = check_factor_args(
        "density_sample_bwd_cuda", planes, lines, coords, axes, live, g)
    dev = coords[0].device

    def new(t, want):
        return torch.empty_like(t) if want else None

    d_planes = [new(p, w) for p, w in zip(planes, need[0:3])]
    d_lines = [new(ln, w) for ln, w in zip(lines, need[3:6])]
    d_coords = [new(c, w) for c, w in zip(coords, need[6:9])]
    cuda_build.launch("density_sample", "density_sample_bwd", _BWD_ARGTYPES,
                      ptrs(planes), ptrs(lines), DIMS(*dims), ptrs(coords),
                      None if live is None else live.data_ptr(),
                      g.data_ptr(), ptrs(d_planes), ptrs(d_lines),
                      ptrs(d_coords), N, dev=dev)
    return d_planes, d_lines, d_coords
