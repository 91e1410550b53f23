"""Quaternion utilities, layout (w, x, y, z)
(counterpart of joint_tensorf_tpu/geometry/quaternion.py:15-58): q <-> R,
the inverse and the Hamilton product on tensors.  R_to_q is the
reference's branchless sqrt / sign construction."""
from __future__ import annotations

import torch


def q_to_R(q):
    """[..., 4] unit quaternion -> [..., 3, 3] rotation."""
    qa, qb, qc, qd = torch.movedim(q, -1, 0)
    return torch.stack([
        torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], dim=-1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                     2 * (qc * qd - qa * qb)], dim=-1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb ** 2 + qc ** 2)], dim=-1),
    ], dim=-2)


def R_to_q(R, eps: float = 1e-8):
    """[..., 3, 3] rotation -> [..., 4] unit quaternion."""
    R00, R11, R22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    t = R00 + R11 + R22
    qa = 0.5 * torch.sqrt(torch.clamp(1 + t, min=0.0) + eps)
    qb = (torch.sign(R[..., 2, 1] - R[..., 1, 2])
          * 0.5 * torch.sqrt(torch.clamp(1 + R00 - R11 - R22, min=0.0) + eps))
    qc = (torch.sign(R[..., 0, 2] - R[..., 2, 0])
          * 0.5 * torch.sqrt(torch.clamp(1 - R00 + R11 - R22, min=0.0) + eps))
    qd = (torch.sign(R[..., 1, 0] - R[..., 0, 1])
          * 0.5 * torch.sqrt(torch.clamp(1 - R00 - R11 + R22, min=0.0) + eps))
    q = torch.stack([qa, qb, qc, qd], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def invert(q):
    """Quaternion inverse: the conjugate over the squared norm."""
    conj = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return conj / torch.sum(q * q, dim=-1, keepdim=True)


def product(q1, q2):
    """Hamilton product q1 q2."""
    a1, b1, c1, d1 = torch.movedim(q1, -1, 0)
    a2, b2, c2, d2 = torch.movedim(q2, -1, 0)
    return torch.stack([
        a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
    ], dim=-1)
