"""Sobel edge-magnitude masks for the edge-guided loss
(counterpart of joint_tensorf_tpu/ops/sobel.py).

3x3 Sobel over replicate-padded RGB images, gradient summed across
channels; the hard mask thresholds the magnitude at mean * thresh, the
soft one divides it by each image's largest.  Written as nine shifted
multiply-adds, like the reference, so no cuDNN convolution (and no TF32
rounding) is involved.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_KX = ((1, 0, -1), (2, 0, -2), (1, 0, -1))
_KY = ((1, 2, 1), (0, 0, 0), (-1, -2, -1))


def _conv3x3(images, k):
    """images: [B, H, W] (already padded by 1) -> [B, H-2, W-2]."""
    H, W = images.shape[1], images.shape[2]
    out = 0.0
    for dy in range(3):
        for dx in range(3):
            out = out + float(k[dy][dx]) * images[:, dy:H - 2 + dy,
                                                  dx:W - 2 + dx]
    return out


def edge_magnitude(images):
    """images: [B, 3, H, W] -> Sobel gradient magnitude [B, H, W]."""
    B, C, H, W = images.shape
    padded = F.pad(images.reshape(B * C, 1, H, W), (1, 1, 1, 1),
                   mode="replicate")[:, 0]
    gx = _conv3x3(padded, _KX).reshape(B, C, H, W).sum(dim=1)
    gy = _conv3x3(padded, _KY).reshape(B, C, H, W).sum(dim=1)
    return torch.sqrt(gx**2 + gy**2)


def hard_edge_mask(images, mean_thresh: float = 1.25):
    """[B,3,H,W] -> uint8 mask [B, H*W]: 1 where magnitude > mean * thresh."""
    B = images.shape[0]
    gg = edge_magnitude(images).reshape(B, -1)
    mean = gg.mean(dim=1, keepdim=True)
    return (gg > mean * mean_thresh).to(torch.uint8)


def soft_edge_mask(images):
    """[B,3,H,W] -> float mask [B, H*W]: the magnitude over each image's
    largest."""
    B = images.shape[0]
    gg = edge_magnitude(images).reshape(B, -1)
    return gg / gg.max(dim=1, keepdim=True).values
