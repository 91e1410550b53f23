"""2D warps of the planar alignment pipeline
(counterpart of joint_tensorf_tpu/geometry/warp2d.py).

Normalized pixel grids (aspect kept, [-1, 1] on the long side), the
SO(2) / SE(2) / SL(3) exponential maps, the warp by its type, and the
corner check of the perturbation sampler.  sl3_to_SL3 is
torch.linalg.matrix_exp where JAX takes jax.scipy.linalg.expm: two
scaling-and-squaring algorithms (a Taylor and a Pade approximant), which
agree to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch


def _axis(n: int, lo: int, hi: int, s: int, device):
    return ((torch.arange(lo, hi, dtype=torch.float32, device=device) + 0.5)
            / n * 2 - 1) * (n / s)


def _grid(y, x):
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def normalized_pixel_grid(H: int, W: int, device=None):
    """[H*W, 2] aspect-normalized pixel centres (x, y) (warp.py:10-16)."""
    s = max(H, W)
    return _grid(_axis(H, 0, H, s, device), _axis(W, 0, W, s, device))


def normalized_pixel_grid_crop(H: int, W: int, H_crop: int, W_crop: int,
                               device=None):
    """The centre crop of the normalized grid (warp.py:18-26)."""
    s = max(H, W)
    return _grid(_axis(H, H // 2 - H_crop // 2, H // 2 + H_crop // 2, s,
                       device),
                 _axis(W, W // 2 - W_crop // 2, W // 2 + W_crop // 2, s,
                       device))


# ------------------------------------------------------------------ Lie maps
def so2_to_SO2(theta):  # [..., 1] -> [..., 2, 2]
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.cat([c, -s], -1), torch.cat([s, c], -1)], -2)


def _taylor_A2(x, nth: int = 10):
    """sin(x) / x."""
    ans, denom = torch.zeros_like(x), 1.0
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def _taylor_B2(x, nth: int = 10):
    """(1 - cos(x)) / x."""
    ans, denom = torch.zeros_like(x), 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        ans = ans + (-1) ** i * x ** (2 * i + 1) / denom
    return ans


def se2_to_SE2(delta):  # [..., 3] -> [..., 2, 3]
    u, theta = delta[..., :2], delta[..., 2:]
    A = _taylor_A2(theta)
    B = _taylor_B2(theta)
    V = torch.stack([torch.cat([A, -B], -1), torch.cat([B, A], -1)], -2)
    return torch.cat([so2_to_SO2(theta), V @ u[..., None]], -1)


def sl3_to_SL3(h):  # [..., 8] -> [..., 3, 3] homography via matrix exp
    h1, h2, h3, h4, h5, h6, h7, h8 = torch.split(h, 1, dim=-1)
    A = torch.stack([torch.cat([h5, h3, h1], -1),
                     torch.cat([h4, -h5 - h6, h2], -1),
                     torch.cat([h7, h8, h6], -1)], -2)
    return torch.linalg.matrix_exp(A)


def warp_grid(xy_grid, warp, warp_type: str):
    """xy_grid: [B, N, 2]; warp: [B, dof] -> warped [B, N, 2]
    (warp.py:28-48)."""
    if warp_type == "translation":
        return xy_grid + warp[..., None, :]
    if warp_type == "rotation":
        return xy_grid @ so2_to_SO2(warp).transpose(-2, -1)
    hom = torch.cat([xy_grid, torch.ones_like(xy_grid[..., :1])], -1)
    if warp_type == "rigid":
        return hom @ se2_to_SE2(warp).transpose(-2, -1)
    if warp_type == "homography":
        out = hom @ sl3_to_SL3(warp).transpose(-2, -1)
        return out[..., :2] / (out[..., 2:] + 1e-8)
    raise ValueError(warp_type)


def warp_corners(warp_param, warp_type: str, H, W, H_crop, W_crop):
    """The crop's 4 corners [..., 4, 2] under ``warp_param`` [..., dof]."""
    s = max(H, W)
    y_crop = (H // 2 - H_crop // 2, H // 2 + H_crop // 2)
    x_crop = (W // 2 - W_crop // 2, W // 2 + W_crop // 2)
    Y = [((y + 0.5) / H * 2 - 1) * (H / s) for y in y_crop]
    X = [((x + 0.5) / W * 2 - 1) * (W / s) for x in x_crop]
    corners = torch.tensor([(X[0], Y[0]), (X[0], Y[1]), (X[1], Y[1]),
                            (X[1], Y[0])], dtype=torch.float32,
                           device=warp_param.device)
    corners = corners.expand(warp_param.shape[:-1] + (4, 2))
    return warp_grid(corners, warp_param, warp_type)


def check_corners_in_range(warp_param, warp_type: str, H, W, H_crop,
                           W_crop) -> bool:
    """Whether every warped crop corner lies inside the image, decided in
    float32 as JAX decides it (the perturbation sampler's rejection
    test: pass a CPU tensor, the decision is read on the host)."""
    c = warp_corners(warp_param, warp_type, H, W, H_crop, W_crop)
    X = (c[..., 0] / W * max(H, W) + 1) / 2 * W - 0.5
    Y = (c[..., 1] / H * max(H, W) + 1) / 2 * H - 0.5
    return bool(((0 <= X) & (X < W) & (0 <= Y) & (Y < H)).all())
