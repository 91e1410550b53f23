"""Pose-gradient maps: per-pixel derivatives of the photometric error in
the camera pose (counterpart of joint_tensorf_tpu/viz/grad_viz.py;
reference nerf.py:444-517).

For one training view, the derivative of each pixel's channel-summed
squared error in a 6-vector delta (angles about X, Y, Z, then a
translation) of a pose composed ahead of the training pose, at delta = 0:
six signed [H, W] maps.

The JAX package takes ``jax.jacrev`` of a chunk's [R] errors in one
shared delta.  ``torch.func.jacrev`` cannot see through the kernels
launched by ctypes (K1/K2), so here each ray of a chunk gets its own zero
delta ([R, 6]) and one backward pass runs over the chunk's summed error.
A pixel's error depends on its own ray alone, so row r of that gradient
is the jacobian's row r.  The chunks pad the pixel list as JAX's do
(``idx % n_pix`` up to a multiple of the chunk) and the padding is cut
off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import poses as pose_ops


def delta_pose(delta):
    """[..., 6] (angles XYZ, translation XYZ) -> [..., 3, 4] poses,
    Rx Ry Rz | t, the identity at zero."""
    rx = pose_ops.angle_to_rotation_matrix(delta[..., 0], "X")
    ry = pose_ops.angle_to_rotation_matrix(delta[..., 1], "Y")
    rz = pose_ops.angle_to_rotation_matrix(delta[..., 2], "Z")
    return torch.cat([rx @ ry @ rz, delta[..., 3:6, None]], dim=-1)


def pose_gradient_maps(render_mse_fn, H: int, W: int,
                       n_rays_chunk: int = 256, device=None, on_chunk=None):
    """``render_mse_fn(delta [R, 6], ray_idx [R])`` -> per-pixel squared
    error [R, 3] of the ray_idx pixels, ray r rendered through delta[r].

    Returns numpy (rot [3, H, W], trans [3, H, W]): d(sum_c mse)/d(delta)
    per pixel.  ``on_chunk(i)`` runs after chunk i's backward pass."""
    n_pix = H * W
    pad = (-n_pix) % n_rays_chunk
    idx_all = torch.arange(n_pix + pad, device=device) % n_pix
    jacs = []
    for i, ray_idx in enumerate(idx_all.reshape(-1, n_rays_chunk)):
        delta = torch.zeros((n_rays_chunk, 6), device=device,
                            requires_grad=True)
        err = render_mse_fn(delta, ray_idx).sum()
        jacs.append(torch.autograd.grad(err, [delta])[0])
        if on_chunk:
            on_chunk(i)
    j = torch.cat(jacs)[:n_pix].cpu().numpy()               # [HW, 6]
    rot = j[:, :3].T.reshape(3, H, W)
    trans = j[:, 3:].T.reshape(3, H, W)
    return np.ascontiguousarray(rot), np.ascontiguousarray(trans)
