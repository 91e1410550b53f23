"""Plain PyTorch of BAT's 2D supervision: the training images blurred by a
sampled Gaussian (separable, replicate padding) and the hard Sobel edge
mask (Joint-TensoRF's train loop: magnitude above mean x threshold)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .field import blur_along, gaussian


def blurred(images, width: float, kernel_size: int):
    """images [V, 3, H, W] blurred by a Gaussian of sigma ``width``
    pixels (the images themselves below 0.01)."""
    if width < 0.01:
        return images
    k = gaussian(width, kernel_size)
    return blur_along(blur_along(images, k, 2), k, 3)


def hard_edges(images, mean_thresh: float):
    """[V, 3, H, W] -> {0, 1} float [V, H, W]: the Sobel magnitude of the
    channel-summed gradients (replicate padding) above its mean x
    ``mean_thresh``."""
    V, C, H, W = images.shape
    kx = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]],
                      device=images.device)
    ky = torch.tensor([[1., 2., 1.], [0., 0., 0.], [-1., -2., -1.]],
                      device=images.device)
    x = F.pad(images.reshape(V * C, 1, H, W), (1, 1, 1, 1), mode="replicate")
    gx = F.conv2d(x, kx[None, None]).reshape(V, C, H, W).sum(1)
    gy = F.conv2d(x, ky[None, None]).reshape(V, C, H, W).sum(1)
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    mean = mag.reshape(V, -1).mean(1)[:, None, None]
    return (mag > mean * mean_thresh).float()
