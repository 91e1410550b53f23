"""Align-corners linear resampling of factor grids as interpolation-matrix
products (counterpart of joint_tensorf_tpu/ops/resample.py).

The matrices are built on the host with numpy, exactly as the JAX package
builds them; upsampling happens only at phase boundaries.
"""
from __future__ import annotations

import numpy as np
import torch


def resize_matrix(src: int, dst: int, dtype=np.float32) -> np.ndarray:
    """[dst, src] align-corners linear interpolation matrix."""
    M = np.zeros((dst, src), dtype=dtype)
    if src == 1:
        M[:, 0] = 1.0
        return M
    if dst == 1:
        M[0, 0] = 1.0
        return M
    pos = np.arange(dst, dtype=np.float64) * (src - 1) / (dst - 1)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, src - 1)
    i1 = np.clip(i0 + 1, 0, src - 1)
    frac = (pos - i0).astype(dtype)
    np.add.at(M, (np.arange(dst), i0), 1.0 - frac)
    np.add.at(M, (np.arange(dst), i1), frac)
    return M


def _mat(src: int, dst: int, like):
    return torch.as_tensor(resize_matrix(src, dst), device=like.device)


def resize_line(line, dst: int):
    """[D, R] -> [dst, R] align-corners linear."""
    return _mat(line.shape[0], dst, line) @ line


def resize_plane(plane, dst_h: int, dst_w: int):
    """[H, W, R] -> [dst_h, dst_w, R] align-corners bilinear."""
    out = torch.einsum("vw,hwr->hvr", _mat(plane.shape[1], dst_w, plane),
                       plane)
    return torch.einsum("uh,hwr->uwr", _mat(plane.shape[0], dst_h, plane),
                        out)
