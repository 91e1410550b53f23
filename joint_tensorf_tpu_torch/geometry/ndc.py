"""NDC reparameterisation for forward-facing (LLFF-style) scenes
(counterpart of joint_tensorf_tpu/geometry/ndc.py).

The reference's convention: cameras face +z, ray origins are shifted to
the near plane first, and the projective scale comes from the intrinsics
(f / c per axis).
"""
from __future__ import annotations

import torch


def convert_ndc(center, ray, intr, near: float = 1.0,
                center_shift: bool = True, detach_center_shift: bool = False):
    """center, ray: [B,N,3]; intr: [B,3,3] -> NDC (center, ray)."""
    if center_shift:
        shift = (near - center[..., 2:]) / ray[..., 2:] * ray
        if detach_center_shift:
            shift = shift.detach()
        center = center + shift

    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    scale_x = (intr[:, 0, 0] / intr[:, 0, 2])[:, None]      # [B,1]
    scale_y = (intr[:, 1, 1] / intr[:, 1, 2])[:, None]
    cxoz, cyoz = cx / cz, cy / cz
    rxoz, ryoz = rx / rz, ry / rz
    center_ndc = torch.stack([scale_x * cxoz, scale_y * cyoz,
                              1 - 2 * near / cz], dim=-1)
    ray_ndc = torch.stack([scale_x * (rxoz - cxoz), scale_y * (ryoz - cyoz),
                           2 * near / cz], dim=-1)
    return center_ndc, ray_ndc


def grad_rescale(source, target):
    """Forward: ``source``; backward: its gradient scaled by
    |target| / max(|source|, 0.1), so NDC-space depths carry
    Euclidean-scale gradients."""
    weight = torch.abs(target) / torch.clamp(torch.abs(source), min=0.1)
    scaled = source * weight
    return scaled + (source - scaled).detach()
