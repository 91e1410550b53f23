"""Coordinate-MLP NeRF with BARF's coarse-to-fine positional encoding
(counterpart of joint_tensorf_tpu/models/nerf_mlp.py).

  * an 8-layer feature MLP with a skip connection, the density taken from
    the last feature layer's first channel, and a 2-layer RGB head on the
    view direction's encoding;
  * TensorFlow-style Xavier init (tf_init: relu gain sqrt(2) but for the
    output layers, gain 1 on the density channel), or the uniform
    +-1/sqrt(fan_in) init, drawn from an explicit torch.Generator;
  * BARF's c2f: cosine-smooth weights per frequency band, driven by the
    training progress;
  * NeRF quadrature with a 1e10 last interval and T = exp(-cumsum(sigma
    delta)) (a different formulation from the VM renderer's compositor:
    no kernel of ops/composite.py is used here, as JAX uses no Pallas
    kernel there).

Parameters are nested dicts {"feat": [{"w": [fan_in, fan_out], "b":
[fan_out]}, ...], "rgb": [...]}, as the JAX package keeps them
(utils/tree.py flattens them into the {name: tensor} dicts the port's
Adam takes).  The MLP's matmuls are plain float32 matmuls (TF32
off, utils/torch_setup.py), as XLA computes them.  Random inputs (the
stratified depth uniforms, the density noise) are taken pre-drawn, so
the parity tests feed JAX's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..render.renderer import _linspace


@dataclasses.dataclass(frozen=True)
class NerfMLPConfig:
    layers_feat: tuple = (256, 256, 256, 256, 256, 256, 256, 256)
    layers_rgb: tuple = (128, 3)
    skip: tuple = (4,)
    L_3D: int = 10
    L_view: int = 4
    posenc: bool = True
    view_dep: bool = True
    density_activ: str = "softplus"   # relu / softplus / abs / sigmoid / exp
    tf_init: bool = True
    barf_c2f: Optional[tuple] = None   # (start, end) progress range or None

    @property
    def input_3d_dim(self):
        return 3 + 6 * self.L_3D if self.posenc else 3

    @property
    def input_view_dim(self):
        return 3 + 6 * self.L_view if self.posenc else 3


def _uniform(shape, bound, gen, device):
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound


def _init_linear(k_in, k_out, cfg: NerfMLPConfig, gen, device, out=None):
    """tf_init (nerf.py:807-817): Xavier uniform with the relu gain except
    output layers; the density channel (out="first") gets gain 1."""
    if not cfg.tf_init:
        bound = 1.0 / math.sqrt(k_in)
        return {"w": _uniform((k_in, k_out), bound, gen, device),
                "b": _uniform((k_out,), bound, gen, device)}

    def xavier(n_out, gain):
        return _uniform((k_in, n_out),
                        gain * math.sqrt(6.0 / (k_in + n_out)), gen, device)

    if out == "all":
        w = xavier(k_out, 1.0)
    elif out == "first":
        w = torch.cat([xavier(1, 1.0), xavier(k_out - 1, math.sqrt(2.0))],
                      dim=1)
    else:
        w = xavier(k_out, math.sqrt(2.0))
    return {"w": w, "b": torch.zeros((k_out,), device=device)}


def init_nerf_mlp(cfg: NerfMLPConfig, gen: torch.Generator, device=None):
    params = {"feat": [], "rgb": []}
    dims = [cfg.input_3d_dim] + list(cfg.layers_feat)
    for li in range(len(dims) - 1):
        k_in, k_out = dims[li], dims[li + 1]
        if li in cfg.skip:
            k_in += cfg.input_3d_dim
        last = li == len(dims) - 2
        params["feat"].append(_init_linear(
            k_in, k_out + 1 if last else k_out, cfg, gen, device,
            out="first" if last else None))
    rdims = [cfg.layers_feat[-1]
             + (cfg.input_view_dim if cfg.view_dep else 0)] + \
        list(cfg.layers_rgb)
    for li in range(len(rdims) - 1):
        params["rgb"].append(_init_linear(
            rdims[li], rdims[li + 1], cfg, gen, device,
            out="all" if li == len(rdims) - 2 else None))
    return params


def c2f_alpha(barf_c2f, progress: float, L: int) -> np.float32:
    """(progress - start) / (end - start) * L in float32, each operation
    rounded as JAX's traced float32 progress rounds it, computed on the
    host: the band weights then need no device scalar."""
    start, end = barf_c2f
    return ((np.float32(progress) - np.float32(start))
            / np.float32(end - start) * np.float32(L))


def positional_encoding(x, L: int, barf_c2f=None, progress=1.0):
    """[..., D] -> [..., 2 * D * L] ([..., D, 2, L] flattened: sin then cos
    of each coordinate), with BARF's c2f band weights at ``progress`` (a
    float) when ``barf_c2f`` (start, end) is given."""
    freq = 2.0 ** torch.arange(L, dtype=torch.float32,
                               device=x.device) * np.float32(np.pi)
    spectrum = x[..., None] * freq                         # [..., D, L]
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    enc = enc.reshape(x.shape[:-1] + (2 * x.shape[-1] * L,))
    if barf_c2f is not None:
        alpha = float(c2f_alpha(barf_c2f, progress, L))
        k = torch.arange(L, dtype=torch.float32, device=x.device)
        weight = (1 - torch.cos(torch.clamp(alpha - k, 0, 1)
                                * np.float32(np.pi))) / 2
        enc = (enc.reshape(-1, L) * weight).reshape(enc.shape)
    return enc


def _activate(cfg: NerfMLPConfig, density):
    act = cfg.density_activ
    if act == "softplus":
        return torch.nn.functional.softplus(density)
    if act == "relu":
        return torch.relu(density)
    if act == "abs":
        # jnp.abs's derivative at 0 is +1 (torch.abs's is 0)
        return torch.where(density >= 0, density, -density)
    if act == "sigmoid":
        return torch.sigmoid(density)
    if act == "exp":
        return torch.exp(density)
    raise ValueError(f"unknown density_activ {act!r}")


def apply_nerf_mlp(params, cfg: NerfMLPConfig, points_3d, ray_unit=None,
                   progress=1.0, noise=None):
    """points_3d, ray_unit: [..., 3] -> (rgb [..., 3], density [...]).
    ``noise``: the density noise already scaled (JAX's normal(rng, shape)
    * density_noise_reg), added before the activation, or None."""
    if cfg.posenc:
        enc = positional_encoding(points_3d, cfg.L_3D, cfg.barf_c2f, progress)
        points_enc = torch.cat([points_3d, enc], dim=-1)
    else:
        points_enc = points_3d
    feat = points_enc
    n_layers = len(params["feat"])
    density = None
    for li, layer in enumerate(params["feat"]):
        if li in cfg.skip:
            feat = torch.cat([feat, points_enc], dim=-1)
        feat = feat @ layer["w"] + layer["b"]
        if li == n_layers - 1:
            density = feat[..., 0]
            if noise is not None:
                density = density + noise
            density = _activate(cfg, density)
            feat = feat[..., 1:]
        feat = torch.relu(feat)
    if cfg.view_dep:
        if ray_unit is None:
            raise ValueError("view_dep needs ray_unit")
        if cfg.posenc:
            ray_enc = torch.cat([ray_unit, positional_encoding(
                ray_unit, cfg.L_view, cfg.barf_c2f, progress)], dim=-1)
        else:
            ray_enc = ray_unit
        feat = torch.cat([feat, ray_enc], dim=-1)
    for li, layer in enumerate(params["rgb"]):
        feat = feat @ layer["w"] + layer["b"]
        if li != len(params["rgb"]) - 1:
            feat = torch.relu(feat)
    return torch.sigmoid(feat), density


def sample_depth(n_rays: int, n_samples: int, near_far, param: str = "metric",
                 uniforms=None, device=None):
    """Depth samples (nerf.py:742-752): [N, S] with stratified ``uniforms``
    [N, S], else [1, S] at the bins' centres; ``param`` "inverse" samples
    1 / depth.  The range is rounded to float32 on the host, as JAX's
    float32 near_far rounds it, so no device scalar is made."""
    dmin, dmax = np.float32(near_far[0]), np.float32(near_far[1])
    rand = uniforms if uniforms is not None else 0.5
    steps = (rand + torch.arange(n_samples, device=device)[None, :]) / \
        n_samples
    depth = steps * float(dmax - dmin) + float(dmin)
    if param == "inverse":
        depth = 1.0 / (depth + 1e-8)
    return depth


def sample_depth_from_pdf(pdf, near_far, n_samples_fine: int):
    """Hierarchical inverse-CDF sampling (nerf.py:754-773): pdf [N, S]
    sample weights -> [N, Sf] fine depths.  The bins and the uniform grid
    are JAX's float32 linspace (render/renderer._linspace)."""
    dev = pdf.device
    S = pdf.shape[-1]
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    grid = _linspace(0.0, 1.0, n_samples_fine + 1, dev)[0]
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(
        cdf.shape[:-1] + (n_samples_fine,)).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), unif, right=True)
    depth_bin = _linspace(near_far[0], near_far[1], S + 1, dev)[0]
    low = torch.clamp(idx - 1, 0, S)
    high = torch.clamp(idx, 0, S)
    depth_low = depth_bin[low]
    depth_high = depth_bin[high]
    cdf_low = torch.gather(cdf, -1, low)
    cdf_high = torch.gather(cdf, -1, high)
    t = (unif - cdf_low) / (cdf_high - cdf_low + 1e-8)
    return depth_low + t * (depth_high - depth_low)


def composite(ray, rgb_samples, density_samples, depth_samples,
              setbg_opaque: bool, bgcolor: float = 1.0):
    """NeRF quadrature (nerf.py:861-877).  ray: [N, 3]; rgb: [N, S, 3];
    density, depth: [N, S] (depth may be [1, S]) -> (rgb [N, 3], depth [N],
    opacity [N], prob [N, S])."""
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)      # [N,1]
    intv = depth_samples[..., 1:] - depth_samples[..., :-1]
    intv = torch.cat([intv, torch.full_like(intv[..., :1], 1e10)], dim=-1)
    sigma_delta = density_samples * (intv * ray_length)
    alpha = 1 - torch.exp(-sigma_delta)
    T = torch.exp(-torch.cumsum(torch.cat(
        [torch.zeros_like(sigma_delta[..., :1]), sigma_delta[..., :-1]],
        dim=-1), dim=-1))
    prob = T * alpha                                               # [N,S]
    depth = torch.sum(depth_samples * prob, dim=-1)
    rgb = torch.sum(rgb_samples * prob[..., None], dim=-2)
    opacity = torch.sum(prob, dim=-1)
    if setbg_opaque:
        rgb = rgb + bgcolor * (1 - opacity[..., None])
    return rgb, depth, opacity, prob
