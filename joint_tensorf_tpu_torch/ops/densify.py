"""Dense-grid density: trilinear lookup of the VM rank expansion
(counterpart of joint_tensorf_tpu/ops/densify.py).

Trilinear weights factorize per axis, so interpolating the dense expansion
G = sum_axes sum_r plane_r (x) line_r at a point equals the factored
plane x line sample there.  The renderer builds G once per step
(models/vm.compute_density_grid) and reads one 8-corner row per sample.

    pack_corners(G [X, Y, Z]) -> G8 [X, Y, Z, 8]
    sample_packed_grid(G8, (cx, cy, cz) [N]) -> [N]

The JAX package has two layouts of the same function: ``packed8`` (this
module's) and ``lane`` (z-runs packed into 128-lane rows for the TPU's
vector unit; tests/test_lane_grid.py pins the two equal).  The port has
both (ops/lane_grid.py is the lane layout's counterpart, an entry point
of its own), and its trainer samples packed8 under either
``tpu.densify_impl`` value: the lane layout moves 16 times the bytes a
sample on the card.  A coordinate exactly on a face gets half the
gradient there (sampling._pix), as JAX's autodiff of the sampler gives.

The row gather's backward is a row scatter-add of the [N, 8] weighted
cotangents into [X*Y*Z, 8]: ops/segment_scatter.scatter_add_rows, kernel K3
on a CUDA tensor, ``index_add_`` on a CPU tensor.  pack_corners is plain
PyTorch, so autograd folds the packed gradient back onto G with the
transposes of its shifts, as JAX's autodiff of the same function does.
"""
from __future__ import annotations

import torch

from .sampling import _floor_frac, _pix
from .segment_scatter import scatter_add_rows


def _shift(a, axis: int):
    """Edge-clamped +1 shift along ``axis``."""
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                     dim=axis)


def pack_corners(G):
    """[X, Y, Z] -> [X, Y, Z, 8]; channel c = dx*4 + dy*2 + dz holds
    G[x+dx, y+dy, z+dz], edge-clamped."""
    g = torch.stack([G, _shift(G, 2)], dim=-1)           # dz
    g = torch.cat([g, _shift(g, 1)], dim=-1)             # dy
    return torch.cat([g, _shift(g, 0)], dim=-1)          # dx


class _RowGather(torch.autograd.Function):
    """table[idx] (read in bf16 and returned as float32 when ``bf16``) with
    the float32 scatter-add backward of K3 (skipped when the table needs no
    gradient)."""

    @staticmethod
    def forward(ctx, table, idx, bf16: bool):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        if bf16:
            return table.to(torch.bfloat16)[idx].to(torch.float32)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        idx, = ctx.saved_tensors
        return scatter_add_rows(idx, g.contiguous(), ctx.n_rows), None, None


def sample_packed_grid(G8, coords, row_dtype: str = "float32"):
    """Trilinear sample of a corner-packed grid: G8 [X, Y, Z, 8] from
    pack_corners, coords (cx, cy, cz) [N] in [-1, 1] (x -> X) -> [N].
    Gradients reach G8 through the row gather and the coordinates through
    the interpolation fractions (the pose path).  ``row_dtype`` "bfloat16"
    reads the rows rounded to bf16 (JAX's lane_grid._bf16_row_gather: the
    grid is cast once, each row fetch moves half the bytes); the weights,
    the coordinate gradients and the float32 scatter of the grid's
    gradient stay float32."""
    X, Y, Z, _ = G8.shape
    cx, cy, cz = coords
    x0, fx = _floor_frac(_pix(cx, X), X)
    y0, fy = _floor_frac(_pix(cy, Y), Y)
    z0, fz = _floor_frac(_pix(cz, Z), Z)
    rows = _RowGather.apply(G8.reshape(X * Y * Z, 8),
                            (x0 * Y + y0) * Z + z0,
                            row_dtype == "bfloat16")               # [N, 8]
    wx = torch.stack([1.0 - fx, fx], dim=-1)
    wy = torch.stack([1.0 - fy, fy], dim=-1)
    wz = torch.stack([1.0 - fz, fz], dim=-1)
    w = (wx[:, :, None, None] * wy[:, None, :, None]
         * wz[:, None, None, :]).reshape(-1, 8)        # c = dx*4 + dy*2 + dz
    return torch.sum(rows * w, dim=-1)
