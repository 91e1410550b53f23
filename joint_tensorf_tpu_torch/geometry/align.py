"""sim(3) Procrustes alignment, camera-pose error metrics and the
batched rigid registration of L2G-BAT
(counterpart of joint_tensorf_tpu/geometry/align.py:18-120).

The evaluation's SVD runs on the host in float64 numpy, as in JAX (the
reference also upcasts to double); the poses stay float32 tensors on
their device.  rigid_points_registration runs on the device inside the
L2G training step and is differentiable.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import poses as pose_ops
from .lie import rotation_distance


@dataclasses.dataclass
class Sim3:
    t0: np.ndarray  # [3]
    t1: np.ndarray
    s0: float
    s1: float
    R: np.ndarray  # [3,3]

    @staticmethod
    def identity():
        return Sim3(t0=np.zeros(3), t1=np.zeros(3), s0=1.0, s1=1.0, R=np.eye(3))


def procrustes_analysis(X0, X1) -> Sim3:
    """Similarity transform aligning X1 to X0 ([N,3] camera centers):
    X1to0 = (X1 - t1) / s1 @ R^T * s0 + t0."""
    X0 = np.asarray(X0, dtype=np.float64)
    X1 = np.asarray(X1, dtype=np.float64)
    t0 = X0.mean(axis=0)
    t1 = X1.mean(axis=0)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = np.sqrt((X0c**2).sum(axis=-1).mean())
    s1 = np.sqrt((X1c**2).sum(axis=-1).mean())
    U, S, Vt = np.linalg.svd(X0c.T / s0 @ (X1c / s1))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return Sim3(t0=t0, t1=t1, s0=float(s0), s1=float(s1), R=R)


def rigid_points_registration(x, y):
    """Differentiable batched Kabsch: (R, t) with R @ x_i + t ~= y_i.

    x, y: [..., N, 3] -> (R [..., 3, 3] with det +1, t [..., 3]).  The
    SVD of the [..., 3, 3] covariance is torch.linalg.svd's; a reflection
    is fixed by the sign of det(U V^T) on U's last column.  Its backward
    divides by s_i^2 - s_j^2, as JAX's does: equal singular values (a
    symmetric point set) give a non-finite gradient on both sides."""
    cx = x.mean(dim=-2, keepdim=True)
    cy = y.mean(dim=-2, keepdim=True)
    xc, yc = x - cx, y - cy
    H = yc.transpose(-2, -1) @ xc                       # [..., 3, 3]
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (U * D[..., None, :]) @ Vt
    t = cy[..., 0, :] - (R @ cx[..., 0, :, None])[..., 0]
    return R, t


def camera_centers(pose):
    """World-space camera centers [N,3] of [N,3,4] world->cam poses."""
    center = torch.zeros((pose.shape[0], 1, 3), dtype=pose.dtype,
                         device=pose.device)
    return pose_ops.cam2world(center, pose)[:, 0]


def _f32(x, like):
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=like.device)


def prealign_cameras(pose, pose_GT):
    """Align predicted poses to GT up to sim(3) -> (pose_aligned [N,3,4],
    sim3); the identity when the SVD does not converge, as in JAX."""
    pose, pose_GT = pose.detach(), pose_GT.detach()
    center_pred = camera_centers(pose)
    center_GT = camera_centers(pose_GT)
    try:
        sim3 = procrustes_analysis(center_GT.cpu().numpy(),
                                   center_pred.cpu().numpy())
    except np.linalg.LinAlgError:
        sim3 = Sim3.identity()
    R_s = _f32(sim3.R, pose)
    center_aligned = ((center_pred - _f32(sim3.t1, pose)) / sim3.s1
                      @ R_s.T * sim3.s0 + _f32(sim3.t0, pose))
    R_aligned = pose[..., :3] @ R_s.T
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return pose_ops.make(R_aligned, t_aligned), sim3


def align_test_pose(pose, sim3: Sim3):
    """Map GT-frame test poses into the learned frame."""
    pose = pose.detach()
    center = camera_centers(pose)
    R_s = _f32(sim3.R, pose)
    center_aligned = ((center - _f32(sim3.t0, pose)) / sim3.s0 @ R_s
                      * sim3.s1 + _f32(sim3.t1, pose))
    R_aligned = pose[..., :3] @ R_s
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return pose_ops.make(R_aligned, t_aligned)


def evaluate_camera_alignment(pose_aligned, pose_GT):
    """Rotation (radians) and translation errors per view."""
    R_aligned, t_aligned = pose_aligned[..., :3], pose_aligned[..., 3:]
    R_GT, t_GT = pose_GT[..., :3], pose_GT[..., 3:]
    R_error = rotation_distance(R_aligned, R_GT)
    t_error = torch.linalg.norm((t_aligned - t_GT)[..., 0], dim=-1)
    return R_error, t_error
