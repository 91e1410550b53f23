"""se(3) <-> SE(3) maps and the rotation distance
(counterpart of joint_tensorf_tpu/geometry/lie.py).

Same truncated Taylor series as the reference (nth=8 for the se(3) forward
map), evaluated in theta^2 so the map and its gradient are smooth at the
zero-initialised pose refinement.  The log map (SE3_to_se3) starts the
pose table at the GT poses of LLFF / t2 captures (start_with_GT_pose).
"""
from __future__ import annotations

import torch


def taylor_A(x, nth: int = 10):
    """sin(x)/x."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        ans = ans + (-1) ** i * (x ** (2 * i) / denom)
    return ans


def taylor_B(x, nth: int = 10):
    """(1-cos(x))/x^2."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        ans = ans + (-1) ** i * (x ** (2 * i) / denom)
    return ans


def taylor_C(x, nth: int = 10):
    """(x-sin(x))/x^3."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + (-1) ** i * (x ** (2 * i) / denom)
    return ans


def _taylor_A_sq(x2, nth: int = 10):
    """sin(x)/x from x^2."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        ans = ans + (-1) ** i * (x2**i / denom)
    return ans


def _taylor_B_sq(x2, nth: int = 10):
    """(1-cos(x))/x^2 from x^2."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        ans = ans + (-1) ** i * (x2**i / denom)
    return ans


def _taylor_C_sq(x2, nth: int = 10):
    """(x-sin(x))/x^3 from x^2."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + (-1) ** i * (x2**i / denom)
    return ans


def skew(w):
    """[...,3] -> [...,3,3] skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    O = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([O, -w2, w1], dim=-1),
            torch.stack([w2, O, -w0], dim=-1),
            torch.stack([-w1, w0, O], dim=-1),
        ],
        dim=-2,
    )


def so3_to_SO3(w):
    """Exponential map so(3) -> SO(3). [...,3] -> [...,3,3]; the series in
    theta^2 keeps the map and its gradient smooth at w = 0."""
    wx = skew(w)
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + _taylor_A_sq(th2) * wx + _taylor_B_sq(th2) * (wx @ wx)


def se3_to_SE3(wu, nth: int = 8):
    """Exponential map se(3) -> SE(3). [...,6] -> [...,3,4] = [R|t]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    I = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A = _taylor_A_sq(th2, nth=nth)
    B = _taylor_B_sq(th2, nth=nth)
    C = _taylor_C_sq(th2, nth=nth)
    wx2 = wx @ wx
    R = I + A * wx + B * wx2
    V = I + B * wx + C * wx2
    t = V @ u[..., None]
    return torch.cat([R, t], dim=-1)


def SO3_to_so3(R, eps: float = 1e-7):
    """Log map SO(3) -> so(3). [...,3,3] -> [...,3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))
    theta = torch.remainder(theta, torch.pi)[..., None, None]
    lnR = 1 / (2 * taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]],
                       dim=-1)


def SE3_to_se3(Rt, eps: float = 1e-8):
    """Log map SE(3) -> se(3). [...,3,4] -> [...,6]."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    I = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    A = taylor_A(theta)
    B = taylor_B(theta)
    invV = I - 0.5 * wx + (1 - A / (2 * B)) / (theta**2 + eps) * (wx @ wx)
    u = (invV @ t)[..., 0]
    return torch.cat([w, u], dim=-1)


def rotation_distance(R1, R2, eps: float = 1e-7):
    """Geodesic angle between rotations [..., 3, 3] (radians)."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))
