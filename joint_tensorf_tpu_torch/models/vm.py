"""VM-decomposed (plane x line) tensorial radiance field
(counterpart of joint_tensorf_tpu/models/vm.py, the fused VM path and the
shape transitions).

The field is an nn.Module: channels-last factor grids ([H, W, R] planes,
[D, R] lines), the appearance basis, the MLP_Fea shading head, and the
scene box ``aabb`` as a buffer.  The box gets no gradient: pose and plane
gradients flow through the sampling coordinates, never into the box
(joint_tensorf_tpu/render/renderer.py:243-250).

Axis conventions: matMode=[[0,1],[0,2],[1,2]], vecMode=[2,1,0]; plane i is
[H=res[m1], W=res[m0], R_i], line i is [D=res[vec_i], R_i].

A shape transition (upsample, shrink) builds a new VMField around new
factor tensors and keeps the basis and shading head; nothing is replaced
in place under autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops import blur as blur_ops
from ..ops import resample
from ..ops.kernels import average_kernel, gaussian_kernel
from ..ops.sampling import sample_planeline_prod
from .shading import MLPFea

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


@dataclasses.dataclass(frozen=True)
class VMConfig:
    """Static field configuration (the fused VM path's subset of the
    reference's VMConfig)."""
    density_n_comp: tuple[int, int, int] = (16, 16, 16)
    app_n_comp: tuple[int, int, int] = (48, 48, 48)
    app_dim: int = 27
    view_pe: int = 2
    fea_pe: int = 2
    hidden: int = 64
    density_shift: float = -10.0
    distance_scale: float = 25.0
    raymarch_weight_thres: float = 1e-6
    step_ratio: float = 0.5


class VMField(nn.Module):
    """Learnable field state: factor grids, basis, shading head, and the
    ``aabb`` buffer."""

    def __init__(self, density_planes, density_lines, app_planes, app_lines,
                 basis, shading: MLPFea, aabb):
        super().__init__()
        P = nn.ParameterList
        self.density_planes = P([nn.Parameter(t) for t in density_planes])
        self.density_lines = P([nn.Parameter(t) for t in density_lines])
        self.app_planes = P([nn.Parameter(t) for t in app_planes])
        self.app_lines = P([nn.Parameter(t) for t in app_lines])
        self.basis = nn.Parameter(basis)
        self.shading = shading
        self.register_buffer("aabb", aabb.reshape(2, 3))

    def resolution(self) -> list[int]:
        """[res_x, res_y, res_z] (W and H of plane 0, D of line 0)."""
        return [self.density_planes[0].shape[1],
                self.density_planes[0].shape[0],
                self.density_lines[0].shape[0]]

    def is_factor(self, name: str) -> bool:
        """Factor grids train at lr_index, basis and shading at lr_basis."""
        return name.split(".")[0] in ("density_planes", "density_lines",
                                      "app_planes", "app_lines")


def init_vm(cfg: VMConfig, resolution: Sequence[int], aabb,
            generator: torch.Generator, init_scale: float = 0.1,
            init_bias: float = 0.0, device=None) -> VMField:
    """Factors |bias + scale*N(0,1)|, basis U(+-1/sqrt(fan_in)), shading
    with nn.Linear's default init, drawn from ``generator``."""
    res = list(resolution)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    def one_svd(n_comp):
        planes, lines = [], []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p = normal((res[m1], res[m0], n_comp[i]))
            planes.append(torch.abs(init_bias + init_scale * p))
            l = normal((res[VEC_MODE[i]], n_comp[i]))
            lines.append(torch.abs(init_bias + init_scale * l))
        return planes, lines

    d_planes, d_lines = one_svd(cfg.density_n_comp)
    a_planes, a_lines = one_svd(cfg.app_n_comp)
    basis_in = sum(cfg.app_n_comp)
    bound = 1.0 / (basis_in ** 0.5)
    basis = (torch.rand((basis_in, cfg.app_dim), generator=generator,
                        device=device) * 2 - 1) * bound
    shading = MLPFea(cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.hidden,
                     device=device, generator=generator)
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=device)
    return VMField(d_planes, d_lines, a_planes, a_lines, basis, shading, aabb)


def normalize_coord(xyz, aabb):
    """World -> [-1,1]; aabb [2, 3] for [..., 3] points or [2] for one axis."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def feature2density(cfg: VMConfig, feat):
    """softplus(feat + shift), the Blender configs' activation."""
    return torch.nn.functional.softplus(feat + cfg.density_shift)


def make_blur_mats(kernel, resolution: Sequence[int]):
    """Per-axis banded blur matrices for a kernel: {axis_len: B}."""
    return {L: blur_ops.blur_matrix(kernel, L)
            for L in set(int(r) for r in resolution)}


def c2f_kernel(mode: str, parameter, kernel_size: int, grid_scale):
    """World-sigma -> grid-units kernel; grid_scale = mean(res / aabb size)."""
    if mode == "uniform-gaussian":
        return gaussian_kernel(grid_scale * parameter, kernel_size)
    if mode == "uniform-average":
        return average_kernel(grid_scale * parameter, kernel_size)
    raise ValueError(f"invalid c2f_mode {mode!r}")


def compute_fused_features(field: VMField, cfg: VMConfig, coords,
                           d_mats=None, c_mats=None):
    """Density and appearance features from ONE fused factor sample per
    axis: density and appearance grids are concatenated channel-wise
    ([H, W, Rd+Ra]) after their own blurs, sampled once, and split.

    coords: (cx, cy, cz) tuple of [N] tensors in [-1,1].
    Returns (sigma_feature [N], app_feature [N, app_dim]).
    """
    Rd = cfg.density_n_comp
    sigma = torch.zeros_like(coords[0])
    app_parts = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        den_p, app_p = field.density_planes[i], field.app_planes[i]
        den_l, app_l = field.density_lines[i], field.app_lines[i]
        if d_mats is not None:
            den_p = blur_ops.blur_plane(den_p, d_mats[den_p.shape[0]],
                                        d_mats[den_p.shape[1]])
            den_l = blur_ops.blur_line(den_l, d_mats[den_l.shape[0]])
        if c_mats is not None:
            app_p = blur_ops.blur_plane(app_p, c_mats[app_p.shape[0]],
                                        c_mats[app_p.shape[1]])
            app_l = blur_ops.blur_line(app_l, c_mats[app_l.shape[0]])
        plane = torch.cat([den_p, app_p], dim=-1)
        line = torch.cat([den_l, app_l], dim=-1)
        prod = sample_planeline_prod(plane, line, coords[m0], coords[m1],
                                     coords[VEC_MODE[i]])
        sigma = sigma + torch.sum(prod[:, :Rd[i]], dim=-1)
        app_parts.append(prod[:, Rd[i]:])
    return sigma, torch.cat(app_parts, dim=-1) @ field.basis


def compute_density_feature(field: VMField, coords):
    """Density feature [N] at normalized coords (cx, cy, cz) from the
    density factors alone, unblurred (the alpha-mask build)."""
    sigma = torch.zeros_like(coords[0])
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        prod = sample_planeline_prod(field.density_planes[i],
                                     field.density_lines[i], coords[m0],
                                     coords[m1], coords[VEC_MODE[i]])
        sigma = sigma + torch.sum(prod, dim=-1)
    return sigma


def density_L1(field: VMField):
    """Mean-abs sparsity on the density factors (planes and lines)."""
    total = 0.0
    for p in field.density_planes:
        total = total + torch.mean(torch.abs(p))
    for l in field.density_lines:
        total = total + torch.mean(torch.abs(l))
    return total


# --------------------------------------------------------- shape transitions
def _with_factors(field: VMField, planes_fn, lines_fn, aabb=None) -> VMField:
    """A new VMField with every factor group mapped, the basis and shading
    head carried over."""
    def planes(group):
        return [planes_fn(i, p.detach()) for i, p in enumerate(group)]

    def lines(group):
        return [lines_fn(i, l.detach()) for i, l in enumerate(group)]

    return VMField(planes(field.density_planes), lines(field.density_lines),
                   planes(field.app_planes), lines(field.app_lines),
                   field.basis.detach(), field.shading,
                   field.aabb if aabb is None else aabb)


@torch.no_grad()
def upsample(field: VMField, res_target: Sequence[int]) -> VMField:
    """Align-corners bilinear upsampling of all factors (the reference's
    tensoRF.py:274-295)."""
    res = [int(r) for r in res_target]
    return _with_factors(
        field,
        lambda i, p: resample.resize_plane(p, res[MAT_MODE[i][1]],
                                           res[MAT_MODE[i][0]]),
        lambda i, l: resample.resize_line(l, res[VEC_MODE[i]]))


@torch.no_grad()
def shrink(field: VMField, new_aabb) -> VMField:
    """Crop the factors to a tightened box (the reference's
    tensoRF.py:297-334).  The integer crop and the snapped box are computed
    on the host in numpy with the JAX package's dtypes (float32 box,
    float64 cell units), so both give the same bounds."""
    aabb = field.aabb.cpu().numpy()
    res = np.asarray(field.resolution())
    units = (aabb[1] - aabb[0]) / (res - 1)
    new_aabb = np.asarray(new_aabb).reshape(2, 3)
    t_l = np.round(np.round((new_aabb[0] - aabb[0]) / units)).astype(np.int64)
    b_r = np.round((new_aabb[1] - aabb[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, res)
    t_l = np.maximum(t_l, 0)
    t_l_r = t_l / (res - 1)
    b_r_r = (b_r - 1) / (res - 1)
    correct = np.zeros_like(new_aabb)
    correct[0] = (1 - t_l_r) * aabb[0] + t_l_r * aabb[1]
    correct[1] = (1 - b_r_r) * aabb[0] + b_r_r * aabb[1]

    def crop_plane(i, p):
        m0, m1 = MAT_MODE[i]
        return p[t_l[m1]:b_r[m1], t_l[m0]:b_r[m0]].clone()

    def crop_line(i, l):
        return l[t_l[VEC_MODE[i]]:b_r[VEC_MODE[i]]].clone()

    return _with_factors(field, crop_plane, crop_line,
                         aabb=torch.as_tensor(correct, dtype=torch.float32,
                                              device=field.aabb.device))
