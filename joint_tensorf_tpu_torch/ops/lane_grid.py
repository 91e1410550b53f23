"""Lane-packed dense-grid trilinear sampling
(counterpart of joint_tensorf_tpu/ops/lane_grid.py).

The dense density grid G [X, Y, Z] packed so that one 128-wide row holds a
run of 32 z entries x the 4 xy corners (lane j*4 + c, c = dx*2 + dy);
blocks advance 31 z cells with 1 halo entry, so any (z0, z0 + 1) pair
lies in one row:

    pack_lane_grid(G [X, Y, Z]) -> G128 [X, Y, Zb, 128]
    unpack_lane_grid_T((X, Y, Z), dG128) -> dG [X, Y, Z]   (its transpose)
    build_lane_grid_vm(planes, lines) -> G128, straight from VM factors
    sample_lane_grid(G128, coords, Z, row_dtype) -> [N]

sample_lane_grid computes the function of ops/densify.sample_packed_grid
(the trainer's sampler for both ``tpu.densify_impl`` values): one [N, 128]
row gather a sample, then a masked dot whose weights factorise per lane,
Wz[j] * wx[dx] * wy[dy].  The gather is densify's row gather, so its
backward is one row scatter-add of [N, 128] float32 rows: kernel K3 on a
CUDA tensor, ``index_add_`` on a CPU tensor; ``row_dtype`` "bfloat16"
reads the rows rounded to bf16 and keeps the weights, the coordinate
gradients and the scatter in float32.

pack_lane_grid's backward is the fold unpack_lane_grid_T: the lanes viewed
as [..., 32, 4] and permuted, the blocks' halos added to the next block's
first slot, the clamped tail rows folded onto the last cell, then the
transposes of the corner shifts.  JAX writes this fold twice (a custom VJP
and a streaming rewrite with a permutation matmul for the TPU's matrix
unit); both compute this one function.

build_lane_grid_vm never makes the dense grid: per axis the corner shifts
and the z blocking act on the small factors and one einsum writes the
packed layout (float32; TF32 is off, utils/torch_setup.py).  The JAX
package measured it slower than G-then-pack on its TPU and calls it from
no entry point; neither does the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .densify import _RowGather, _shift
from .sampling import _floor_frac, _pix

ZRUN = 31          # z cells a block advances (32 entries with the halo)
LANES = 128        # 32 z entries x 4 xy corners


def n_blocks(Z: int) -> int:
    return -(-max(Z - 1, 1) // ZRUN)


def _zpad(a, Z: int, dim: int):
    """``a`` along ``dim`` (length Z) padded to n_blocks(Z) * 31 + 1 with
    copies of its last entry."""
    pad = n_blocks(Z) * ZRUN + 1 - Z
    if pad == 0:
        return a
    last = a.narrow(dim, Z - 1, 1)
    return torch.cat([a, last.expand(*a.shape[:dim], pad,
                                     *a.shape[dim + 1:])], dim=dim)


def _block_z(f, Z: int):
    """[D = Z, ...] -> [Zb, 32, ...]: overlapping z windows (31 + 1 halo),
    edge-clamp padded."""
    return _zpad(f, Z, 0).unfold(0, ZRUN + 1, ZRUN).movedim(-1, 1)


def _pack(G):
    X, Y, Z = G.shape
    gy = _shift(G, 1)
    g4 = torch.stack([G, gy, _shift(G, 0), _shift(gy, 0)], dim=-1)
    blocks = _zpad(g4, Z, 2).unfold(2, ZRUN + 1, ZRUN)   # [X, Y, Zb, 4, 32]
    return blocks.transpose(-1, -2).reshape(X, Y, -1, LANES)


def _unshift_T(d, dim: int):
    """Transpose of the edge-clamped +1 _shift along ``dim``: out[i+1] +=
    d[i], the last slot clamping onto itself."""
    n = d.shape[dim]
    out = torch.cat([torch.zeros_like(d.narrow(dim, 0, 1)),
                     d.narrow(dim, 0, n - 1)], dim=dim)
    out.narrow(dim, n - 1, 1).add_(d.narrow(dim, n - 1, 1))
    return out


def unpack_lane_grid_T(shape, dP):
    """Transpose of pack_lane_grid: dP [X, Y, Zb, 128] -> dG [X, Y, Z]."""
    X, Y, Z = shape
    Zb = n_blocks(Z)
    lanes = dP.reshape(X, Y, Zb, ZRUN + 1, 4).permute(0, 1, 4, 2, 3)
    # [X, Y, 4, Zb, 32]: entry j < 31 of block b is z = b*31 + j; the
    # halo j = 31 is z = (b + 1)*31, the next block's first slot
    dz = F.pad(lanes[..., :ZRUN].reshape(X, Y, 4, Zb * ZRUN), (0, 1))
    dz[..., ZRUN::ZRUN] += lanes[..., ZRUN]
    if dz.shape[-1] > Z:           # clamped tail rows fold onto the last cell
        tail = dz[..., Z:].sum(-1)
        dz = dz[..., :Z].clone()
        dz[..., -1] += tail
    # the corner shifts' transposes, c = dx*2 + dy over [G, Gy, Gx, Gxy]
    return (dz[:, :, 0] + _unshift_T(dz[:, :, 1], 1)
            + _unshift_T(dz[:, :, 2], 0)
            + _unshift_T(_unshift_T(dz[:, :, 3], 1), 0))


class _PackLaneGrid(torch.autograd.Function):

    @staticmethod
    def forward(ctx, G):
        ctx.shape = tuple(G.shape)
        return _pack(G)

    @staticmethod
    def backward(ctx, dP):
        return unpack_lane_grid_T(ctx.shape, dP)


def pack_lane_grid(G):
    """[X, Y, Z] -> [X, Y, Zb, 128]: entry (x, y, zb, j*4 + c) holds
    G[x+dx, y+dy, zb*31 + j] for c = dx*2 + dy, j in 0..31 (edge-clamped;
    z rows past Z-1 clamp to the last cell).  Its gradient is the fold
    unpack_lane_grid_T."""
    return _PackLaneGrid.apply(G)


def build_lane_grid_vm(planes, lines):
    """pack_lane_grid(sum over axes and components of plane (x) line) from
    the factors (activations and blur already applied; plane i [res[m1],
    res[m0], R_i], line i [res[vec_i], R_i] as models/vm.py lays them
    out; z, the lane-run axis, is grid axis 2), in float32."""
    P = planes[0]                                       # [Y, X, R]
    Y, X, _ = P.shape
    Z = lines[0].shape[0]
    # axis 0: plane [y, x, r] x line [z, r]; both corner shifts on the plane
    Py = _shift(P, 0)
    P4 = torch.stack([P, Py, _shift(P, 1), _shift(Py, 1)], dim=-1)
    G = torch.einsum("yxrc,bjr->xybjc", P4, _block_z(lines[0], Z))
    # axis 1: plane [z, x, r] x line [y, r]; dx on the plane, dy on the line
    P1 = planes[1]
    P1b = _block_z(torch.stack([P1, _shift(P1, 1)], dim=-1), Z)
    L1 = torch.stack([lines[1], _shift(lines[1], 0)], dim=-1)
    t1 = torch.einsum("bjxrd,yre->xybjde", P1b, L1)
    # axis 2: plane [z, y, r] x line [x, r]; dy on the plane, dx on the line
    P2 = planes[2]
    P2b = _block_z(torch.stack([P2, _shift(P2, 1)], dim=-1), Z)
    L2 = torch.stack([lines[2], _shift(lines[2], 0)], dim=-1)
    t2 = torch.einsum("bjyre,xrd->xybjde", P2b, L2)
    shape = (X, Y, -1, LANES)
    return G.reshape(shape) + t1.reshape(shape) + t2.reshape(shape)


def sample_lane_grid(G128, coords, Z: int, row_dtype: str = "float32"):
    """Trilinear sample of a lane-packed grid: G128 [X, Y, Zb, 128] from
    pack_lane_grid, coords a (cx, cy, cz) tuple of [N] tensors or an
    [N, 3] tensor in [-1, 1] (x -> X), Z the unpacked z extent -> [N].
    A coordinate exactly on a face gets half the gradient, as JAX's
    jnp.clip gives it (sampling._pix)."""
    X, Y, Zb, _ = G128.shape
    if isinstance(coords, (tuple, list)):
        cx, cy, cz = coords
    else:
        cx, cy, cz = coords.unbind(-1)
    x0, fx = _floor_frac(_pix(cx, X), X)
    y0, fy = _floor_frac(_pix(cy, Y), Y)
    z0, fz = _floor_frac(_pix(cz, Z), Z)
    zb = z0 // ZRUN
    zl = (z0 - zb * ZRUN)[:, None]                   # 0..30
    rows = _RowGather.apply(G128.reshape(X * Y * Zb, LANES),
                            (x0 * Y + y0) * Zb + zb,
                            row_dtype == "bfloat16")           # [N, 128]
    # lane j = z_slot*4 + c carries corner c = dx*2 + dy at z offset
    # z_slot - zl in {0, 1}
    lane = torch.arange(LANES, device=G128.device)
    zslot = lane >> 2
    fx, fy, fz = fx[:, None], fy[:, None], fz[:, None]
    zero = fz.new_zeros(())
    Wz = (torch.where(zslot == zl, 1.0 - fz, zero)
          + torch.where(zslot == zl + 1, fz, zero))
    Wxy = (torch.where((lane & 2) != 0, fx, 1.0 - fx)
           * torch.where((lane & 1) != 0, fy, 1.0 - fy))
    return torch.sum(rows * (Wz * Wxy), dim=-1)
