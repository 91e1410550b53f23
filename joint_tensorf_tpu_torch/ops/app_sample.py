"""The concatenated plane x line appearance sample on the card: kernel
K7's wrappers (csrc/app_sample.cu).

    app_sample_fwd_cuda(planes, lines, coords, axes) -> [N, R_0 + R_1 + R_2]
        for each axis a, plane_a(u, v)[r] * line_a(w)[r], u, v, w =
        coords[axes[a][0..2]], the axes' channels one after another
    app_sample_bwd_cuda(..., g, need) -> the gradients asked for

Each launches once and adds one to ``cuda_build.LAUNCHES`` under its C
entry point's name.  The autograd Function around them and the plain
version (any CPU tensor) are ops/sampling.py's SamplePlaneLineProdCat and
sample_planeline_prod_cat_plain.  Float32 only: the wrappers raise on any
other type, on tensors off one CUDA device, and on bad shapes
(cuda_build.check_factor_args, as K6's wrappers).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import DIMS, check_factor_args, ptrs

_P, _A, _I = cuda_build.VOIDP, cuda_build.PTR_ARRAY, cuda_build.INT_ARRAY

_ARGTYPES = {
    "app_sample_fwd": [_A, _A, _I, _A, _P, ctypes.c_longlong, _P],
    "app_sample_bwd": [_A, _A, _I, _A, _P, _A, _A, _A, ctypes.c_longlong,
                       _P]}


def _channels(planes) -> int:
    return sum(p.shape[2] for p in planes)


def app_sample_fwd_cuda(planes, lines, coords, axes):
    """Launch K7's forward: planes [H_a, W_a, R_a], lines [D_a, R_a] and
    coords (x, y, z) [N] float32 contiguous on one CUDA device; axes[a] =
    (u, v, w), the coordinates plane a reads along W and H and line a
    along D -> feature [N, R_0 + R_1 + R_2] float32."""
    dims, N = check_factor_args("app_sample_fwd_cuda", planes, lines, coords,
                                axes)
    out = torch.empty((N, _channels(planes)), dtype=torch.float32,
                      device=coords[0].device)
    cuda_build.launch("app_sample", "app_sample_fwd",
                      _ARGTYPES["app_sample_fwd"], ptrs(planes),
                      ptrs(lines), DIMS(*dims), ptrs(coords),
                      out.data_ptr(), N, dev=out.device)
    return out


def app_sample_bwd_cuda(planes, lines, coords, axes, g, need=(True,) * 9):
    """Launch K7's backward with the feature's cotangent g [N, R_0 + R_1 +
    R_2]: returns (d_planes, d_lines, d_coords), three each, None where
    ``need`` (nine flags: the planes, the lines, the coordinates) asks for
    none.  The factor gradients are the planes' and lines' shapes, zeroed
    and added into by the kernel; the coordinates' are written at every
    slot."""
    dims, N = check_factor_args("app_sample_bwd_cuda", planes, lines, coords,
                                axes, g=g, g_width=_channels(planes))
    dev = coords[0].device

    def new(t, want):
        return torch.empty_like(t) if want else None

    d_planes = [new(p, w) for p, w in zip(planes, need[0:3])]
    d_lines = [new(ln, w) for ln, w in zip(lines, need[3:6])]
    d_coords = [new(c, w) for c, w in zip(coords, need[6:9])]
    cuda_build.launch("app_sample", "app_sample_bwd",
                      _ARGTYPES["app_sample_bwd"], ptrs(planes),
                      ptrs(lines), DIMS(*dims), ptrs(coords),
                      g.data_ptr(), ptrs(d_planes), ptrs(d_lines),
                      ptrs(d_coords), N, dev=dev)
    return d_planes, d_lines, d_coords
