"""Factor-grid sampling: the plain plane / line / 3D-grid samples
(counterpart of joint_tensorf_tpu/ops/sampling.py:33-64 and :466-504) and
the fused plane x line factor sample with its hand-written backward
(:219-426).

    sample_plane(plane [H,W,R], u, v [N]) -> [N,R]    autograd through gathers
    sample_line(line [D,R], w [N]) -> [N,R]
    sample_grid3d(grid [X,Y,Z], (x, y, z) [N]) -> [N]    trilinear (alpha mask)
    sample_planeline_prod(plane [H,W,R], line [D,R], u, v, w [N]) -> p(u,v) * l(w)  [N,R]

Bilinear plane / linear line sampling with align_corners semantics,
channels-last, clamped to the border.  The backward returns all five
gradients: the factor gradients (one corner-packed row scatter per plane,
folded densely; a one-hot matmul for the short line) and the coordinate
gradients d_u, d_v, d_w, with the border masks of the reference, which are
the path pose gradients take.

Forward and backward are plain PyTorch, except the packed-plane scatter,
which goes through ops/segment_scatter.scatter_add_rows: kernel K3 on a
CUDA tensor, ``index_add_`` on a CPU tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .segment_scatter import scatter_add_rows


def _pix(coord, size: int):
    """Normalized [-1,1] -> continuous pixel index [0, size-1] (align corners)."""
    return torch.clamp((coord + 1.0) * 0.5 * (size - 1), 0.0, size - 1.0)


def _floor_frac(x, size: int):
    x0 = torch.clamp(torch.floor(x.detach()), 0, size - 2 if size > 1 else 0)
    return x0.long(), x - x0


def sample_line(line, w):
    """line [D, R]; w [N] normalized coord along the line axis -> [N, R]."""
    D = line.shape[0]
    i0, fx = _floor_frac(_pix(w, D), D)
    i1 = torch.clamp(i0 + 1, max=D - 1)
    return line[i0] * (1.0 - fx)[:, None] + line[i1] * fx[:, None]


def sample_plane(plane, u, v):
    """plane [H, W, R]; u (->W axis), v (->H axis) [N] in [-1,1] -> [N, R]."""
    H, W, R = plane.shape
    x0, fx = _floor_frac(_pix(u, W), W)
    y0, fy = _floor_frac(_pix(v, H), H)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = plane.reshape(H * W, R)
    w00, w01, w10, w11 = _bilinear_weights(fx, fy)
    return (flat[y0 * W + x0] * w00 + flat[y0 * W + x1] * w01
            + flat[y1 * W + x0] * w10 + flat[y1 * W + x1] * w11)


def sample_grid3d(grid, x, y, z):
    """Trilinear sample of a dense [X, Y, Z] grid at per-axis normalized
    coords x, y, z [N] in [-1,1] -> [N] (the alpha mask's lookup)."""
    X, Y, Z = grid.shape
    x0, fx = _floor_frac(_pix(x, X), X)
    y0, fy = _floor_frac(_pix(y, Y), Y)
    z0, fz = _floor_frac(_pix(z, Z), Z)
    x1 = torch.clamp(x0 + 1, max=X - 1)
    y1 = torch.clamp(y0 + 1, max=Y - 1)
    z1 = torch.clamp(z0 + 1, max=Z - 1)
    flat = grid.reshape(-1)

    def gat(xi, yi, zi):
        return flat[(xi * Y + yi) * Z + zi]

    c00 = gat(x0, y0, z0) * (1 - fz) + gat(x0, y0, z1) * fz
    c01 = gat(x0, y1, z0) * (1 - fz) + gat(x0, y1, z1) * fz
    c10 = gat(x1, y0, z0) * (1 - fz) + gat(x1, y0, z1) * fz
    c11 = gat(x1, y1, z0) * (1 - fz) + gat(x1, y1, z1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def pack_plane(plane):
    """[H, W, R] -> [H, W, 4R]: (self, x+1, y+1, x+1&y+1), edge-clamped."""
    px = torch.cat([plane[:, 1:], plane[:, -1:]], dim=1)
    py = torch.cat([plane[1:], plane[-1:]], dim=0)
    pxy = torch.cat([py[:, 1:], py[:, -1:]], dim=1)
    return torch.cat([plane, px, py, pxy], dim=-1)


def pack_line(line):
    """[D, R] -> [D, 2R]: (self, next), edge-clamped."""
    nxt = torch.cat([line[1:], line[-1:]], dim=0)
    return torch.cat([line, nxt], dim=-1)


def _plane_fold(d_packed, H: int, W: int, R: int):
    """Transpose of pack_plane's clamped shifts: [H*W, 4R] -> [H, W, R]."""
    dp = d_packed.reshape(H, W, 4 * R)
    d_plane = dp[..., :R].clone()
    dx = dp[..., R:2 * R]
    d_plane[:, 1:] += dx[:, :-1]
    d_plane[:, -1] += dx[:, -1]
    dy = dp[..., 2 * R:3 * R]
    d_plane[1:] += dy[:-1]
    d_plane[-1] += dy[-1]
    dxy = dp[..., 3 * R:]
    dxy_s = F.pad(dxy[:, :-1], (0, 0, 1, 0))
    dxy_s[:, -1] += dxy[:, -1]
    d_plane[1:] += dxy_s[:-1]
    d_plane[-1] += dxy_s[-1]
    return d_plane


def _line_fold(d_packed, D: int, R: int):
    """Transpose of pack_line's clamped shift: [D, 2R] -> [D, R]."""
    d_line = d_packed[:, :R].clone()
    dn = d_packed[:, R:]
    d_line[1:] += dn[:-1]
    d_line[-1] += dn[-1]
    return d_line


def _scatter_rows_matmul(idx, updates, n_rows: int):
    """zeros([n_rows, C]).at[idx].add(updates) for a short destination (the
    line factors) as onehot(idx)^T @ updates; f32 one-hots keep every
    product exact, only the summation order differs from a scatter."""
    onehot = (torch.arange(n_rows, device=idx.device)[None, :]
              == idx[:, None]).to(updates.dtype)
    return onehot.T @ updates


def _bilinear_weights(fx, fy):
    return (((1 - fy) * (1 - fx))[:, None], ((1 - fy) * fx)[:, None],
            (fy * (1 - fx))[:, None], (fy * fx)[:, None])


class SamplePlaneLineProd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plane, line, u, v, w):
        H, W, R = plane.shape
        D = line.shape[0]
        x0, fx = _floor_frac(_pix(u, W), W)
        y0, fy = _floor_frac(_pix(v, H), H)
        i0, fz = _floor_frac(_pix(w, D), D)
        rows = pack_plane(plane).reshape(H * W, 4 * R)[y0 * W + x0]
        w00, w01, w10, w11 = _bilinear_weights(fx, fy)
        p = (rows[:, :R] * w00 + rows[:, R:2 * R] * w01
             + rows[:, 2 * R:3 * R] * w10 + rows[:, 3 * R:] * w11)
        lrows = pack_line(line)[i0]
        l = lrows[:, :R] * (1.0 - fz)[:, None] + lrows[:, R:] * fz[:, None]
        ctx.save_for_backward(plane, line, u, v, w)
        return p * l

    @staticmethod
    def backward(ctx, g):
        plane, line, u, v, w = ctx.saved_tensors
        H, W, R = plane.shape
        D = line.shape[0]
        g = g.contiguous()
        x_raw = (u + 1.0) * 0.5 * (W - 1)
        y_raw = (v + 1.0) * 0.5 * (H - 1)
        z_raw = (w + 1.0) * 0.5 * (D - 1)
        x0, fx = _floor_frac(torch.clamp(x_raw, 0.0, W - 1.0), W)
        y0, fy = _floor_frac(torch.clamp(y_raw, 0.0, H - 1.0), H)
        i0, fz = _floor_frac(torch.clamp(z_raw, 0.0, D - 1.0), D)
        idx = y0 * W + x0
        rows = pack_plane(plane).reshape(H * W, 4 * R)[idx]       # [N, 4R]
        f00, f01, f10, f11 = (rows[:, :R], rows[:, R:2 * R],
                              rows[:, 2 * R:3 * R], rows[:, 3 * R:])
        lrows = pack_line(line)[i0]                               # [N, 2R]
        l0, l1 = lrows[:, :R], lrows[:, R:]
        w00, w01, w10, w11 = _bilinear_weights(fx, fy)
        p = f00 * w00 + f01 * w01 + f10 * w10 + f11 * w11
        l = l0 * (1.0 - fz)[:, None] + l1 * fz[:, None]
        gl = g * l
        gp = g * p
        g4 = torch.cat([gl * w00, gl * w01, gl * w10, gl * w11], -1)
        g2 = torch.cat([gp * (1.0 - fz)[:, None], gp * fz[:, None]], -1)
        dp_dx = (f01 - f00) * (1 - fy)[:, None] + (f11 - f10) * fy[:, None]
        dp_dy = (f10 - f00) * (1 - fx)[:, None] + (f11 - f01) * fx[:, None]
        mx = ((x_raw > 0) & (x_raw < W - 1)).to(g.dtype)
        my = ((y_raw > 0) & (y_raw < H - 1)).to(g.dtype)
        mz = ((z_raw > 0) & (z_raw < D - 1)).to(g.dtype)
        d_u = torch.sum(gl * dp_dx, -1) * (0.5 * (W - 1)) * mx
        d_v = torch.sum(gl * dp_dy, -1) * (0.5 * (H - 1)) * my
        d_w = torch.sum(gp * (l1 - l0), -1) * (0.5 * (D - 1)) * mz
        d_pk = scatter_add_rows(idx, g4, H * W)
        d_lk = _scatter_rows_matmul(i0, g2, D)
        return (_plane_fold(d_pk, H, W, R), _line_fold(d_lk, D, R),
                d_u, d_v, d_w)


def sample_planeline_prod(plane, line, u, v, w):
    """p(u,v) * l(w): plane [H,W,R], line [D,R], u (->W), v (->H),
    w (->D) [N] in [-1,1] -> [N,R]."""
    return SamplePlaneLineProd.apply(plane, line, u, v, w)
