"""Separable Gaussian filtering of factor grids and images as matmuls
(counterpart of joint_tensorf_tpu/ops/blur.py).

The banded matrix B[i, j] = sum_k kernel[k] * [clip(i + k - half) == j] is
the 1D 'same' convolution with replicate padding (the reference's grouped
conv1d, bateRF.py:8-39), or with zero padding for the planar images
(terms past either end dropped).  Applying it is a plain float32 matmul,
as XLA did it; TF32 is off (utils/torch_setup.py).
"""
from __future__ import annotations

import torch


def blur_matrix(kernel, length: int, padding: str = "replicate"):
    """[L, L] matrix equivalent to 1D 'same' convolution; blurred = B @ x.
    ``padding``: "replicate" (the 3D factor blur, bateRF.py:16) or "zero"
    (the planar pipeline's conv1d padding="same", planar_svd.py:318)."""
    taps = kernel.shape[-1]
    half = taps // 2
    dev = kernel.device
    i = torch.arange(length, device=dev)[:, None]         # [L, 1]
    k = torch.arange(taps, device=dev)[None, :]           # [1, T]
    raw = i + k - half
    cols = torch.clamp(raw, 0, length - 1)                # [L, T]
    rows = i.expand(cols.shape)
    vals = kernel.expand(cols.shape)
    if padding == "zero":
        vals = torch.where((raw >= 0) & (raw < length), vals,
                           torch.zeros_like(vals))
    B = torch.zeros((length, length), dtype=kernel.dtype, device=dev)
    return B.index_put((rows.reshape(-1), cols.reshape(-1)),
                       vals.reshape(-1), accumulate=True)


def blur_line(line, B_d):
    """line: [D, R]; B_d: [D, D] -> [D, R]."""
    return B_d @ line


def blur_plane(plane, B_h, B_w):
    """plane: [H, W, R]; separable 2D blur = two matmuls."""
    out = torch.einsum("vw,hwr->hvr", B_w, plane)   # blur along W
    return torch.einsum("uh,hwr->uwr", B_h, out)    # blur along H


def blur_images_hw(images, B_h, B_w):
    """images: [..., H, W]; separable 2D blur along the trailing two axes."""
    out = torch.einsum("vw,...hw->...hv", B_w, images)
    return torch.einsum("uh,...hw->...uw", B_h, out)
