"""Camera pose ([R|t], shape [...,3,4]) algebra
(counterpart of joint_tensorf_tpu/geometry/poses.py)."""
from __future__ import annotations

import torch


def make(R, t):
    """Build a [...,3,4] pose from R [...,3,3] and t [...,3]."""
    return torch.cat([R, t[..., None]], dim=-1)


def invert(pose):
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-2, -1)
    t_inv = (-R_inv @ t)[..., 0]
    return make(R_inv, t_inv)


def compose_pair(pose_a, pose_b):
    """pose_new(x) = pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    R_new = R_b @ R_a
    t_new = (R_b @ t_a + t_b)[..., 0]
    return make(R_new, t_new)


def compose(pose_list):
    """compose([p1, p2, ..., pN])(x) = pN(...(p2(p1(x))))."""
    out = pose_list[0]
    for p in pose_list[1:]:
        out = compose_pair(out, p)
    return out


def to_hom(X):
    """[..., 3] -> [..., 4] homogeneous coordinates."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def cam2world(X, pose):
    """Camera-frame points X [..., N, 3] of world->cam poses -> world."""
    return to_hom(X) @ invert(pose).transpose(-1, -2)
