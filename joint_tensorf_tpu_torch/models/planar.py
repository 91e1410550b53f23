"""Planar (2D) neural images of the alignment sanity pipeline
(counterpart of joint_tensorf_tpu/models/planar.py).

Three parameterisations with one forward contract, coords [B, N, 2] ->
rgb [B, N, 3]:

  * the SVD image: rank-R separable factors with the scheduled rank (a
    mask on the components, as JAX keeps shapes static) and the scheduled
    component-wise 1D Gaussian blur with zero padding (reference
    planar_svd.py:236-349);
  * the FFT image: PREF-style complex64 Fourier line factors, their
    inverse FFT (norm="forward"), the blur on the complex lines, the two
    Fourier bases, and the Parseval regulariser (planar_fft.py:47-126);
  * the MLP image: BARF's coordinate MLP with c2f positional-encoding
    weights (planar.py:282-337).

The factor products, blur matrices and MLP layers are plain float32 (and
complex64) matmuls and einsums, as XLA computes them (no Pallas kernel
in JAX); the image samples are ops/sampling.sample_image's gathers.
Initialisers draw from an explicit torch.Generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import blur as blur_ops
from ..ops.sampling import sample_image
from .nerf_mlp import positional_encoding


# --------------------------------------------------------------- SVD image
def init_svd_image(max_ranks: int, W: int, H: int, gen: torch.Generator,
                   scale: float = 0.1, device=None):
    """rank1 [3, R, W] (x-factors), rank2 [3, R, H] (y-factors)
    (planar_svd.py:290-297)."""
    return {"rank1": scale * torch.randn((3, max_ranks, W), generator=gen,
                                         device=device),
            "rank2": scale * torch.randn((3, max_ranks, H), generator=gen,
                                         device=device)}


def _rank_mask(R: int, cur_rank, device):
    return (torch.arange(R, device=device) < cur_rank)[None, :, None]


def svd_image_forward(params, coords, kernel=None, cur_rank=None,
                      interp_before_product: bool = True,
                      mode: str = "bilinear"):
    """coords [B, N, 2] -> rgb [B, N, 3].  ``kernel``: a [taps] blur
    applied to each component with zero padding; components >=
    ``cur_rank`` are masked to zero.  With ``interp_before_product`` each
    1D factor is sampled at the warped coordinate and the products summed
    (planar_svd.py:326-334), else the whole image is built and sampled
    (:338-344)."""
    r1, r2 = params["rank1"], params["rank2"]          # [3,R,W], [3,R,H]
    R, W, H = r1.shape[1], r1.shape[2], r2.shape[2]
    if cur_rank is not None:
        mask = _rank_mask(R, cur_rank, r1.device).to(r1.dtype)
        r1 = r1 * mask
        r2 = r2 * mask
    if kernel is not None:
        Bw = blur_ops.blur_matrix(kernel, W, padding="zero")
        Bh = blur_ops.blur_matrix(kernel, H, padding="zero")
        r1 = torch.einsum("crw,vw->crv", r1, Bw)
        r2 = torch.einsum("crh,vh->crv", r2, Bh)
    if interp_before_product:
        outs = []
        for c in coords:
            x = (c[:, 0] + 1.0) * W / 2.0 - 0.5
            y = (c[:, 1] + 1.0) * H / 2.0 - 0.5
            xs = _sample_lines(r1, x, mode)                # [3, R, N]
            ys = _sample_lines(r2, y, mode)
            outs.append(torch.sum(xs * ys, dim=1).T)       # [N, 3]
        return torch.stack(outs)
    img = torch.einsum("crh,crw->chw", r2, r1)             # [3, H, W]
    return torch.stack([sample_image(img, c, mode=mode) for c in coords])


def _sample_lines(lines, pix, mode: str):
    """lines [3, R, L] at continuous pixel coordinates pix [N]
    (align_corners=False, zero padding) -> [3, R, N]."""
    L = lines.shape[-1]

    def corner(xi, w=None):
        inb = (xi >= 0) & (xi < L)
        vals = lines[:, :, torch.clamp(xi, 0, L - 1)]
        return vals * (inb if w is None else w * inb)[None, None, :]

    if mode == "nearest":
        return corner(torch.round(pix).long())
    x0f = torch.floor(pix.detach())
    fx = pix - x0f
    x0 = x0f.long()
    return corner(x0, 1 - fx) + corner(x0 + 1, fx)


def svd_tv_loss(params, max_ranks: int):
    """planar_svd.py:220-233."""
    r1, r2 = params["rank1"], params["rank2"]
    n1 = r1.shape[2] * max_ranks
    n2 = r2.shape[2] * max_ranks
    return (torch.sum((r1[..., 1:] - r1[..., :-1]) ** 2) / n1
            + torch.sum((r2[..., 1:] - r2[..., :-1]) ** 2) / n2)


# --------------------------------------------------------------- FFT image
def init_fft_image(W: int, H: int, device=None):
    """Complex Fourier line factors, zero (planar_fft.py:73-81): rank1
    [3, W // 5, H], rank2 [3, H // 5, W]."""
    return {"rank1": torch.zeros((3, W // 5, H), dtype=torch.complex64,
                                 device=device),
            "rank2": torch.zeros((3, H // 5, W), dtype=torch.complex64,
                                 device=device)}


def _fourier_basis(R: int, n: int, device):
    """exp(2 pi i r k / n) [R, n] in complex64, its phase rounded in
    float32 in JAX's order ((2 pi r) / n) * k."""
    r = torch.arange(R, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(n, dtype=torch.float32, device=device)[None, :]
    phase = (np.float32(2 * np.pi) * r) / n * k
    return torch.complex(torch.cos(phase), torch.sin(phase))


def fft_image_reconstruct(params, cur_rank=None, kernel=None):
    """-> the real [3, H, W] image: the real part of the inverse-FFT lines
    times their Fourier bases, summed (planar_fft.py:83-106)."""
    r1, r2 = params["rank1"], params["rank2"]
    R1, H = r1.shape[1], r1.shape[2]
    R2, W = r2.shape[1], r2.shape[2]
    if cur_rank is not None:
        r1 = r1 * _rank_mask(R1, cur_rank, r1.device)
        r2 = r2 * _rank_mask(R2, cur_rank, r2.device)
    r1_i = torch.fft.ifft(r1, dim=2, norm="forward")
    r2_i = torch.fft.ifft(r2, dim=2, norm="forward")
    if kernel is not None:
        Bh = blur_ops.blur_matrix(kernel, H, padding="zero")
        Bw = blur_ops.blur_matrix(kernel, W, padding="zero")
        r1_i = torch.einsum("crh,vh->crv", r1_i, Bh.to(r1_i.dtype))
        r2_i = torch.einsum("crw,vw->crv", r2_i, Bw.to(r2_i.dtype))
    # the reference's broadcasting (planar_fft.py:101-104) is only
    # coherent for square images; the constraint is kept
    assert H == W, "FFT planar image requires square resolution"
    img1 = torch.einsum("ra,crb->cab", _fourier_basis(R1, H, r1.device), r1_i)
    img2 = torch.einsum("cra,rb->cab", r2_i, _fourier_basis(R2, W, r2.device))
    return torch.real(img1) + torch.real(img2)


def fft_image_forward(params, coords, cur_rank=None, kernel=None,
                      mode: str = "bilinear"):
    img = fft_image_reconstruct(params, cur_rank, kernel)
    return torch.stack([sample_image(img, c, mode=mode) for c in coords])


def _safe_norm(r):
    """L2 norm with a zero (not NaN) gradient at r = 0: the FFT image's
    coefficients start exactly at zero."""
    s = torch.sum(torch.real(r * torch.conj(r)))
    nonzero = s > 0
    return torch.sqrt(torch.where(nonzero, s, torch.ones_like(s))) * nonzero


def fft_parseval_loss(params):
    """planar_fft.py:119-126."""
    r1, r2 = params["rank1"], params["rank2"]
    R1, H = r1.shape[1], r1.shape[2]
    R2, W = r2.shape[1], r2.shape[2]
    dev = r1.device
    r1_v = torch.arange(H, device=dev)[None, None, :] * r1
    r1_u = torch.arange(R1, device=dev)[None, :, None] * r1
    r2_v = torch.arange(W, device=dev)[None, None, :] * r2
    r2_u = torch.arange(R2, device=dev)[None, :, None] * r2
    return sum(_safe_norm(r) for r in [r1_v, r1_u, r2_v, r2_u])


# --------------------------------------------------------------- MLP image
def init_mlp_image(layers, L_2D: int, gen: torch.Generator, skip=(),
                   barf_c2f=None, device=None):
    """BARF's planar MLP (planar.py:289-303): uniform +-1/sqrt(fan_in),
    the first layer scaled by sqrt(input_dim / 2) with c2f."""
    input_dim = 2 + 4 * L_2D
    dims = [input_dim] + list(layers)
    params = []
    for li in range(len(dims) - 1):
        k_in = dims[li] + (input_dim if li in skip else 0)
        bound = 1.0 / math.sqrt(k_in)
        w = (torch.rand((k_in, dims[li + 1]), generator=gen, device=device)
             * 2 - 1) * bound
        b = (torch.rand((dims[li + 1],), generator=gen, device=device)
             * 2 - 1) * bound
        if barf_c2f is not None and li == 0:
            s = math.sqrt(input_dim / 2.0)
            w, b = w * s, b * s
        params.append({"w": w, "b": b})
    return params


def mlp_image_forward(params, coords, L_2D: int, skip=(), barf_c2f=None,
                      progress=1.0):
    """coords [B, N, 2] -> rgb [B, N, 3] with BARF's c2f weights at
    ``progress`` (a float) (planar.py:305-337)."""
    enc = positional_encoding(coords, L_2D, barf_c2f, progress)
    feat = torch.cat([coords, enc], dim=-1)
    inp = feat
    for li, layer in enumerate(params):
        if li in skip:
            feat = torch.cat([feat, inp], dim=-1)
        feat = feat @ layer["w"] + layer["b"]
        if li != len(params) - 1:
            feat = torch.relu(feat)
    return torch.sigmoid(feat)
