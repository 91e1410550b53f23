"""Ray generation from camera intrinsics/extrinsics
(counterpart of joint_tensorf_tpu/geometry/rays.py).

Pixel centers at +0.5, ray directions = grid_3D @ R, camera centers
= -t^T @ R.  The pixel grid carries no gradient; centers and directions stay
differentiable w.r.t. the pose so pose gradients flow through rendering.
"""
from __future__ import annotations

import torch


def pixel_grid(H: int, W: int, dtype=torch.float32, device=None):
    """[H*W, 2] pixel-center coordinates (x, y)."""
    y = torch.arange(H, dtype=dtype, device=device) + 0.5
    x = torch.arange(W, dtype=dtype, device=device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def img2cam(X, intr_inv):
    """Homogeneous pixel coordinates [..., 3] -> camera space."""
    return X @ intr_inv.transpose(-1, -2)


def camera_grid_3d(H: int, W: int, intr_inv, ray_idx=None):
    """Back-projected pixel grid [B, N, 3] (N = H*W or len(ray_idx))."""
    grid = pixel_grid(H, W, dtype=intr_inv.dtype, device=intr_inv.device)
    if ray_idx is not None:
        grid = grid[ray_idx]
    grid_h = torch.cat([grid, torch.ones_like(grid[..., :1])], dim=-1)
    return img2cam(grid_h[None], intr_inv).detach()


def get_center_and_ray(H: int, W: int, pose, intr_inv, ray_idx=None):
    """pose: [B,3,4] world->cam -> (centers [B,N,3], dirs [B,N,3])."""
    grid_3d = camera_grid_3d(H, W, intr_inv, ray_idx=ray_idx)
    t = pose[..., 3:]          # [B,3,1]
    R = pose[..., :3]          # [B,3,3]
    ray_dirs = grid_3d @ R     # [B,N,3]
    centers = -(t.transpose(-2, -1) @ R)  # [B,1,3]
    centers = centers.expand(ray_dirs.shape)
    return centers, ray_dirs
