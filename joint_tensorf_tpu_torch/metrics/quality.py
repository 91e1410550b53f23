"""Image quality metrics: PSNR and SSIM
(counterpart of joint_tensorf_tpu/metrics/quality.py).

SSIM as the reference evaluates it (pytorch-ssim): an 11 x 11 Gaussian
window with sigma 1.5, per channel with zero padding, averaged;
C1 = 0.01^2, C2 = 0.03^2 on [0, 1] images.  The window's correlation is
one grouped conv2d (no kernel of the TPU's is involved).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred, target):
    return -10.0 * torch.log10(torch.mean((pred - target) ** 2))


def _gaussian_window(size: int = 11, sigma: float = 1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.as_tensor(np.outer(g, g), dtype=torch.float32)


def _filter2d(img, window):
    """img [C, H, W]: per-channel correlation with the window, zero
    padded to the input's size."""
    C = img.shape[0]
    k = window.shape[0]
    w = window.to(img.device)[None, None].expand(C, 1, k, k)
    return F.conv2d(img[None], w, padding=k // 2, groups=C)[0]


def ssim(pred, target, window_size: int = 11):
    """pred/target: [C,H,W] or [H,W,C] in [0,1] -> scalar mean SSIM."""
    if pred.ndim == 3 and pred.shape[-1] in (1, 3):
        pred = torch.movedim(pred, -1, 0)
        target = torch.movedim(target, -1, 0)
    window = _gaussian_window(window_size)
    mu1 = _filter2d(pred, window)
    mu2 = _filter2d(target, window)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(pred * pred, window) - mu1_sq
    sigma2_sq = _filter2d(target * target, window) - mu2_sq
    sigma12 = _filter2d(pred * target, window) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def lpips_fn():
    """LPIPS is not computed: it needs the ``lpips`` package and AlexNet
    weights, a download.  Returns None, and the evaluate entry point
    records why in its output (``lpips_note``)."""
    return None
