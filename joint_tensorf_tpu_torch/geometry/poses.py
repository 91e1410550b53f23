"""Camera pose ([R|t], shape [...,3,4]) algebra
(counterpart of joint_tensorf_tpu/geometry/poses.py)."""
from __future__ import annotations

import torch


def make(R=None, t=None):
    """Build a [...,3,4] pose from R [...,3,3] and/or t [...,3]: the
    identity rotation without R, the zero translation without t."""
    assert R is not None or t is not None
    if R is None:
        t = torch.as_tensor(t)
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(
            t.shape[:-1] + (3, 3))
    elif t is None:
        R = torch.as_tensor(R)
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
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


def world2cam(X, pose):
    """World points X [..., N, 3] -> the frame of world->cam poses."""
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2world(X, pose):
    """Camera-frame points X [..., N, 3] of world->cam poses -> world."""
    return to_hom(X) @ invert(pose).transpose(-1, -2)


def angle_to_rotation_matrix(a, axis: str):
    """[...] angles -> [..., 3, 3] rotations about the named axis: the
    rotation about Z, its rows and columns rolled by 1 (X) or 2 (Y), as
    the reference builds it (camera.py:220-229)."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    O = torch.zeros_like(a)
    I = torch.ones_like(a)
    M = torch.stack([
        torch.stack([torch.cos(a), -torch.sin(a), O], dim=-1),
        torch.stack([torch.sin(a), torch.cos(a), O], dim=-1),
        torch.stack([O, O, I], dim=-1),
    ], dim=-2)
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))
