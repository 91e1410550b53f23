"""Bilinear plane sampling with a tile-binned plane-gradient scatter:
kernel K4 and its plain version
(counterpart of joint_tensorf_tpu/ops/binned_scatter.py).

    sample_plane_binned(plane [H,W,R], u, v [N]) -> [N,R]

A drop-in for ops/sampling.sample_plane with a hand-written backward:

  * forward: the plain 4-corner gather (sample_plane);
  * d_plane: every sample adds g * w into the four corners of its cell,
    (x0, y0) clamped as _pixel_bins does, through plane_grad_scatter:
    kernel K4 (csrc/binned_scatter.cu) on a CUDA tensor, four
    ``index_add_`` on a CPU tensor.  There is no other path;
  * d_u, d_v: autograd of the gather-only sample with the plane held
    constant, as the JAX backward's vjp of the stop-gradient closure.

The wrapper buckets the samples by TS x TS-cell plane tile (one sort, as
the JAX wrapper sorts outside its kernel) and cuts each tile's range of
the sorted order into chunks of at most CHUNK samples; the kernel runs one
block per chunk.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .sampling import _floor_frac, _pix, sample_plane

TS = 10          # tile side in cells; the block accumulates (TS+1)^2 x R
CHUNK = 2048     # samples per block at most
_MAX_SMEM = 232448                          # bytes a Hopper block may use
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


def pixel_bins(u, v, H: int, W: int):
    """(x0, y0, fx, fy): the integer cell and fractions of each sample,
    clamped like sample_plane (x0 <= W-2, y0 <= H-2)."""
    x0, fx = _floor_frac(_pix(u, W), W)
    y0, fy = _floor_frac(_pix(v, H), H)
    return x0, y0, fx, fy


def _corners(x0, y0, fx, fy, H: int, W: int):
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    return ((y0 * W + x0, (1 - fy) * (1 - fx)), (y0 * W + x1, (1 - fy) * fx),
            (y1 * W + x0, fy * (1 - fx)), (y1 * W + x1, fy * fx))


def plane_grad_scatter_plain(g, x0, y0, fx, fy, H: int, W: int):
    """The plain PyTorch version (any device): four row scatter-adds."""
    R = g.shape[1]
    out = torch.zeros((H * W, R), dtype=torch.float32, device=g.device)
    for idx, w in _corners(x0, y0, fx, fy, H, W):
        out.index_add_(0, idx, g * w[:, None])
    return out.reshape(H, W, R)


def tile_grid(H: int, W: int):
    """(n_ty, n_tx): tiles per axis; the last cell index is H-2 / W-2."""
    return ((H - 2) // TS + 1 if H > 1 else 1,
            (W - 2) // TS + 1 if W > 1 else 1)


def bucket_by_tile(x0, y0, H: int, W: int):
    """Sort the samples by TS x TS-cell tile and cut each tile's range into
    chunks of at most CHUNK samples: (order [N], the sample indices tile by
    tile; chunk_tile, chunk_lo, chunk_hi [n_chunks], each chunk's tile and
    range of order; cell [N], y0 * W + x0), all int32."""
    n_ty, n_tx = tile_grid(H, W)
    tid = (y0 // TS) * n_tx + x0 // TS
    order = torch.argsort(tid).to(torch.int32)
    counts = torch.bincount(tid, minlength=n_ty * n_tx)
    seg_lo = torch.cumsum(counts, 0) - counts
    n_chunks = (counts + CHUNK - 1) // CHUNK
    chunk_tile = torch.repeat_interleave(
        torch.arange(n_ty * n_tx, device=tid.device), n_chunks)
    first = torch.cumsum(n_chunks, 0) - n_chunks
    j = torch.arange(chunk_tile.shape[0], device=tid.device) \
        - first[chunk_tile]
    lo = seg_lo[chunk_tile] + j * CHUNK
    hi = torch.minimum(lo + CHUNK, (seg_lo + counts)[chunk_tile])
    i32 = torch.int32
    return (order, chunk_tile.to(i32), lo.to(i32), hi.to(i32),
            (y0 * W + x0).to(i32))


def launch_binned(g, order, chunk_tile, chunk_lo, chunk_hi, cell, fx, fy,
                  H: int, W: int):
    """Launch K4 on bucketed samples (bucket_by_tile) -> [H, W, R]."""
    R = g.shape[1]
    _, n_tx = tile_grid(H, W)
    out = torch.zeros((H, W, R), dtype=torch.float32, device=g.device)
    fn = cuda_build.kernel("binned_scatter", "binned_plane_scatter",
                           _ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), order.data_ptr(), chunk_tile.data_ptr(),
                 chunk_lo.data_ptr(), chunk_hi.data_ptr(), cell.data_ptr(),
                 fx.data_ptr(), fy.data_ptr(), chunk_tile.shape[0], H, W, R,
                 n_tx, TS, out.data_ptr(), stream)
    cuda_build.LAUNCHES["binned_plane_scatter"] += 1
    cuda_build.check(err, "binned_plane_scatter")
    return out


def plane_grad_scatter_cuda(g, x0, y0, fx, fy, H: int, W: int):
    """K4: g [N, R] float32, x0/y0 [N] int, fx/fy [N] float32, all on one
    CUDA device -> d_plane [H, W, R] float32."""
    if not (g.is_cuda and all(t.device == g.device
                              for t in (x0, y0, fx, fy))):
        raise ValueError("plane_grad_scatter_cuda: inputs must be on one "
                         "CUDA device")
    if g.dtype != torch.float32 or fx.dtype != torch.float32 or \
            fy.dtype != torch.float32:
        raise TypeError(f"plane_grad_scatter_cuda: want float32 g, fx, fy, "
                        f"got {g.dtype}, {fx.dtype}, {fy.dtype}")
    N, R = g.shape
    if any(t.shape != (N,) for t in (x0, y0, fx, fy)):
        raise ValueError("plane_grad_scatter_cuda: x0, y0, fx, fy must be "
                         f"[{N}]")
    smem = (TS + 1) ** 2 * R * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"plane_grad_scatter_cuda: R={R} needs {smem} B of "
                         f"shared memory, more than a block has")
    if N == 0 or R == 0:
        return torch.zeros((H, W, R), dtype=torch.float32, device=g.device)
    return launch_binned(g.contiguous(), *bucket_by_tile(x0, y0, H, W),
                         fx.contiguous(), fy.contiguous(), H, W)


def plane_grad_scatter(g, x0, y0, fx, fy, H: int, W: int):
    """K4 on a CUDA tensor, the plain version on a CPU tensor."""
    if g.is_cuda:
        return plane_grad_scatter_cuda(g, x0, y0, fx, fy, H, W)
    if g.device.type != "cpu":
        raise ValueError(f"plane_grad_scatter: no kernel for {g.device}")
    return plane_grad_scatter_plain(g, x0, y0, fx, fy, H, W)


class SamplePlaneBinned(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plane, u, v):
        ctx.save_for_backward(plane, u, v)
        return sample_plane(plane, u, v)

    @staticmethod
    def backward(ctx, g):
        plane, u, v = ctx.saved_tensors
        H, W, _ = plane.shape
        g = g.contiguous()
        x0, y0, fx, fy = pixel_bins(u.detach(), v.detach(), H, W)
        d_plane = plane_grad_scatter(g, x0, y0, fx, fy, H, W)
        # coordinate grads through the gather-only sample, plane constant
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            vv = v.detach().requires_grad_(True)
            out = sample_plane(plane.detach(), uu, vv)
            d_u, d_v = torch.autograd.grad(out, (uu, vv), g)
        return d_plane.to(plane.dtype), d_u, d_v


def sample_plane_binned(plane, u, v):
    """sample_plane with the tile-binned plane-gradient scatter (K4)."""
    return SamplePlaneBinned.apply(plane, u, v)
