"""Novel-view camera trajectories, world->cam poses [n, 3, 4] in float32
(counterpart of joint_tensorf_tpu/viz/novel_views.py:21-53; reference
camera.py:368-402): small circular oscillations around an anchor pose,
and an orbit around the scene's bounding box.
"""
from __future__ import annotations

import math

import torch

from ..geometry import poses as pose_ops


def _theta(n: int, device):
    """n angles evenly spaced over one turn, computed as JAX does."""
    return torch.arange(n, dtype=torch.float32, device=device) / n \
        * 2 * math.pi


def novel_view_poses(pose_anchor, n: int = 60, scale: float = 1.0):
    """Oscillations around ``pose_anchor`` [3, 4], on its device."""
    pose_anchor = torch.as_tensor(pose_anchor, dtype=torch.float32)
    dev = pose_anchor.device
    theta = _theta(n, dev)
    R_x = pose_ops.angle_to_rotation_matrix(
        torch.arcsin(torch.sin(theta) * 0.05), "X")
    R_y = pose_ops.angle_to_rotation_matrix(
        torch.arcsin(torch.cos(theta) * 0.05), "Y")
    pose_rot = pose_ops.make(R=R_y @ R_x)
    pose_shift = pose_ops.make(t=torch.tensor([0, 0, -4.0 * scale],
                                              device=dev))
    pose_shift2 = pose_ops.make(t=torch.tensor([0, 0, 3.8 * scale],
                                               device=dev))
    pose_oscil = pose_ops.compose([pose_shift, pose_rot, pose_shift2])
    return pose_ops.compose([pose_oscil, pose_anchor[None]])


def novel_view_around_bbox(scene_bbox, n: int = 120, scale: float = 1.0,
                           device=None):
    """An orbit of n views around ``scene_bbox`` (6 numbers: min, max) on
    ``device``: at 0.6 x the box diagonal from its centre, raised by a
    tenth of its height and pitched towards it."""
    bbox = torch.as_tensor(scene_bbox, dtype=torch.float32,
                           device=device).reshape(2, 3)
    norm = torch.linalg.norm(bbox[0] - bbox[1])
    theta = _theta(n, bbox.device)
    camera_dist = norm * 0.6 * scale
    bbox_height = torch.abs(bbox[1, 1] - bbox[0, 1])
    h_above = bbox_height * 0.1 * scale
    pitch = torch.arctan(h_above / camera_dist)

    R_x = pose_ops.angle_to_rotation_matrix(
        torch.full_like(theta, 1.0) * pitch, "X")
    R_y = pose_ops.angle_to_rotation_matrix(theta, "Y")
    R_dwn = pose_ops.angle_to_rotation_matrix(
        torch.full_like(theta, math.pi / 2), "X")
    t = torch.stack([torch.zeros_like(theta),
                     torch.ones_like(theta) * h_above,
                     torch.ones_like(theta) * camera_dist], dim=-1)
    return pose_ops.make(R=R_x @ R_y @ R_dwn, t=t)
