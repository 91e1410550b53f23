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

On a CUDA tensor the route launches csrc/binned_scatter.cu twice:
``bucket_by_tile`` (count, scan and fill kernels: the samples bucketed by
TS x TS-cell plane tile, by position, without sorting and without moving a
row of g; the fill also zeroes the output pixels that tiles share) and
``accumulate`` (K4 proper, one block per chunk of at most CHUNK samples of
one tile).  The route sizes every array and the grid from N, H, W and R
alone (``plan``), so it never waits on the host.  ``bucket_by_tile_plain``
builds the same table with torch ops (for tests).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .sampling import _floor_frac, _pix, sample_plane
from .tile_scatter import Bucketing, empty_bucketing

TS = 10          # tile side in cells (csrc/binned_scatter.cu: kTS)
CHUNK = 2048     # samples per accumulate block, at most
_MAX_SMEM = 232448                          # bytes a Hopper block may use
_P = ctypes.c_void_p
_BUCKET_ARGTYPES = [_P, _P, ctypes.c_longlong] + [ctypes.c_int] * 7 + \
    [_P] * 7 + [ctypes.c_int, _P]
_ACC_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 6 + [_P]


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


class TilePlan(NamedTuple):
    """Sizes of one bucketing: the tile grid, n_buckets = n_ty x n_tx tiles
    and n_map accumulate blocks (ceil(N / CHUNK) + n_buckets bounds the
    chunks, since each tile has max(1, ceil(count / CHUNK)) of them)."""
    n_ty: int
    n_tx: int
    n_buckets: int
    n_map: int


def plan(N: int, H: int, W: int) -> TilePlan:
    n_ty, n_tx = tile_grid(H, W)
    return TilePlan(n_ty, n_tx, n_ty * n_tx, -(-N // CHUNK) + n_ty * n_tx)


def smem_bytes(R: int) -> int:
    """Shared memory of one accumulate block: the (TS+1)^2 x R float32
    tile, the chunk's sorted positions and the cell keys' starts."""
    return ((TS + 1) ** 2 * R + CHUNK + TS * TS + 1) * 4


def cell_key(lx, ly):
    """Key of cell (lx, ly) within its tile, as csrc/binned_scatter.cu
    sorts a chunk: parity class (ly & 1, lx & 1) first, so that the cells
    of one class, which share no corner pixel, are one range of keys."""
    q = TS // 2
    return ((ly % 2) * 2 + lx % 2) * q * q + (ly // 2) * q + lx // 2


def bucket_by_tile_plain(x0, y0, H: int, W: int) -> Bucketing:
    """The bucketing of bucket_by_tile in torch ops (one stable sort), the
    same table: samples tile by tile, in index order inside a tile."""
    N = x0.shape[0]
    p = plan(N, H, W)
    x0, y0 = x0.long(), y0.long()
    tile = (y0 // TS) * p.n_tx + x0 // TS
    order = torch.argsort(tile, stable=True)
    counts = torch.bincount(tile, minlength=p.n_buckets)
    chunks = torch.clamp(-(-counts // CHUNK), min=1)
    zero = counts.new_zeros(1)
    offset = torch.cat([zero, torch.cumsum(counts, 0)])
    chunk_start = torch.cat([zero, torch.cumsum(chunks, 0)])
    chunk_bucket = torch.full((p.n_map,), -1, dtype=torch.long,
                              device=x0.device)
    chunk_bucket[:int(chunk_start[-1])] = torch.repeat_interleave(
        torch.arange(p.n_buckets, device=x0.device), chunks)
    key = cell_key(x0 % TS, y0 % TS)
    perm = torch.stack([order, key[order]], 1)
    return Bucketing(*(t.to(torch.int32).contiguous() for t in (
        perm, counts, offset, offset[1:], chunk_start, chunk_bucket)))


def bucket_by_tile(x0, y0, H: int, W: int, R: int):
    """Bucket the samples by tile (csrc/binned_scatter.cu passes 1-3) ->
    (Bucketing, out): the output [H, W, R] is uninitialised except for the
    pixels that the accumulate adds into atomically, which are zeroed."""
    N = x0.shape[0]
    p = plan(N, H, W)
    bk = empty_bucketing(N, p, x0.device)
    out = torch.empty((H, W, R), dtype=torch.float32, device=x0.device)
    fn = cuda_build.kernel("binned_scatter", "binned_bucket",
                           _BUCKET_ARGTYPES)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x0.data_ptr(), y0.data_ptr(), N, H, W, TS, p.n_tx, p.n_ty,
                 CHUNK, p.n_map,
                 *(t.data_ptr() for t in bk), out.data_ptr(), R, stream)
    cuda_build.check(err, "binned_bucket")
    return bk, out


def accumulate(g, bk: Bucketing, out, fx, fy):
    """Launch K4 proper on a bucketing (bucket_by_tile) of g's rows -> out
    [H, W, R]."""
    H, W, R = out.shape
    p = plan(g.shape[0], H, W)
    fn = cuda_build.kernel("binned_scatter", "binned_plane_scatter",
                           _ACC_ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                 bk.perm.data_ptr(), bk.offset.data_ptr(),
                 bk.chunk_start.data_ptr(), bk.chunk_bucket.data_ptr(),
                 out.data_ptr(), H, W, R, p.n_tx, CHUNK, p.n_map, stream)
    cuda_build.LAUNCHES["binned_plane_scatter"] += 1
    cuda_build.check(err, "binned_plane_scatter")
    return out


def plane_grad_scatter_cuda(g, x0, y0, fx, fy, H: int, W: int):
    """K4: g [N, R] float32, x0/y0 [N] int64 (pixel_bins), fx/fy [N]
    float32, all on one CUDA device -> d_plane [H, W, R] float32."""
    if not (g.is_cuda and all(t.device == g.device
                              for t in (x0, y0, fx, fy))):
        raise ValueError("plane_grad_scatter_cuda: inputs must be on one "
                         "CUDA device")
    if g.dtype != torch.float32 or fx.dtype != torch.float32 or \
            fy.dtype != torch.float32:
        raise TypeError(f"plane_grad_scatter_cuda: want float32 g, fx, fy, "
                        f"got {g.dtype}, {fx.dtype}, {fy.dtype}")
    if x0.dtype != torch.int64 or y0.dtype != torch.int64:
        raise TypeError(f"plane_grad_scatter_cuda: want int64 x0, y0, got "
                        f"{x0.dtype}, {y0.dtype}")
    N, R = g.shape
    if any(t.shape != (N,) for t in (x0, y0, fx, fy)):
        raise ValueError("plane_grad_scatter_cuda: x0, y0, fx, fy must be "
                         f"[{N}]")
    smem = smem_bytes(R)
    if smem > _MAX_SMEM:
        raise ValueError(f"plane_grad_scatter_cuda: R={R} needs {smem} B of "
                         f"shared memory, more than a block has")
    if N == 0 or R == 0:
        return torch.zeros((H, W, R), dtype=torch.float32, device=g.device)
    if max(N, plan(N, H, W).n_map) >= 2 ** 31:
        raise ValueError(f"plane_grad_scatter_cuda: N={N} samples exceed "
                         f"the kernels' int32 positions")
    bk, out = bucket_by_tile(x0.contiguous(), y0.contiguous(), H, W, R)
    return accumulate(g.contiguous(), bk, out, fx.contiguous(),
                      fy.contiguous())


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
