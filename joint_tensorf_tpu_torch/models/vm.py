"""VM-decomposed (plane x line) tensorial radiance field
(counterpart of joint_tensorf_tpu/models/vm.py, the fused VM path and the
shape transitions).

The field is an nn.Module: channels-last factor grids ([H, W, R] planes,
[D, R] lines), the appearance basis, the shading head (MLP_Fea or
MLP_Fea_WeakView, VMConfig.shading_mode), and the scene box ``aabb`` as
a buffer.  The density activation is softplus or relu
(VMConfig.fea2dense); the TV terms of the LLFF configs are tv_loss_density
and tv_loss_app.  The box gets no gradient: pose and plane
gradients flow through the sampling coordinates, never into the box
(joint_tensorf_tpu/render/renderer.py:243-250).

Axis conventions: matMode=[[0,1],[0,2],[1,2]], vecMode=[2,1,0]; plane i is
[H=res[m1], W=res[m0], R_i], line i is [D=res[vec_i], R_i].

A shape transition (upsample, shrink) builds a new VMField around new
factor tensors and keeps the basis and shading head; nothing is replaced
in place under autograd.

Factors are stored in ``VMConfig.factor_dtype`` (float32, or bfloat16 as
the JAX package's tpu.factor_dtype offers); every computation reads them
as float32 (_blurred), so a bf16 factor's gradient is the float32 one
rounded once to bf16 where the factor is converted, as JAX's cotangent of
its float32 promotion is.  Basis, shading and the box stay float32.
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
from .shading import SHADING_HEADS

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
    factor_dtype: str = "float32"            # factor storage: or "bfloat16"
    shading_mode: str = "MLP_Fea"            # or "MLP_Fea_WeakView"
    fea2dense: str = "softplus"              # or "relu"


class VMField(nn.Module):
    """Learnable field state: factor grids, basis, shading head, and the
    ``aabb`` buffer."""

    def __init__(self, density_planes, density_lines, app_planes, app_lines,
                 basis, shading: nn.Module, aabb):
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
            init_bias: float = 0.0, device=None, init_density: bool = True,
            init_app: bool = True, init_basis: bool = True,
            prev: VMField | None = None) -> VMField:
    """Factors |bias + scale*N(0,1)| in cfg.factor_dtype, basis
    U(+-1/sqrt(fan_in)), shading with nn.Linear's default init, drawn from
    ``generator``.  With ``prev`` (the reference's reset_on_last_upsample,
    joint_tensorf_tpu/models/vm.py:106-151), the groups not re-initialised
    are carried over from it unchanged, and so is the shading head."""
    res = list(resolution)
    fdt = getattr(torch, cfg.factor_dtype)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    def one_svd(n_comp):
        planes, lines = [], []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p = normal((res[m1], res[m0], n_comp[i]))
            planes.append(torch.abs(init_bias + init_scale * p).to(fdt))
            l = normal((res[VEC_MODE[i]], n_comp[i]))
            lines.append(torch.abs(init_bias + init_scale * l).to(fdt))
        return planes, lines

    d_planes, d_lines = one_svd(cfg.density_n_comp)
    a_planes, a_lines = one_svd(cfg.app_n_comp)
    basis_in = sum(cfg.app_n_comp)
    bound = 1.0 / (basis_in ** 0.5)
    basis = (torch.rand((basis_in, cfg.app_dim), generator=generator,
                        device=device) * 2 - 1) * bound
    shading = make_shading(cfg, device, generator)
    if prev is not None:
        def carry(group):
            return [t.detach() for t in group]

        if not init_density:
            d_planes = carry(prev.density_planes)
            d_lines = carry(prev.density_lines)
        if not init_app:
            a_planes, a_lines = carry(prev.app_planes), carry(prev.app_lines)
        if not init_basis:
            basis = prev.basis.detach()
        shading = prev.shading
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=device)
    return VMField(d_planes, d_lines, a_planes, a_lines, basis, shading, aabb)


def make_shading(cfg: VMConfig, device=None,
                 generator: torch.Generator | None = None) -> nn.Module:
    """The config's shading head, drawn from ``generator``."""
    return SHADING_HEADS[cfg.shading_mode](
        cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.hidden, device=device,
        generator=generator)


def normalize_coord(xyz, aabb):
    """World -> [-1,1]; aabb [2, 3] for [..., 3] points or [2] for one axis."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def feature2density(cfg: VMConfig, feat):
    """softplus(feat + shift) (the Blender configs) or relu(feat + shift)
    (the LLFF configs)."""
    if cfg.fea2dense == "relu":
        return torch.relu(feat + cfg.density_shift)
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
        den_p, den_l = _blurred(field.density_planes[i],
                                field.density_lines[i], d_mats)
        app_p, app_l = _blurred(field.app_planes[i], field.app_lines[i],
                                c_mats)
        plane = torch.cat([den_p, app_p], dim=-1)
        line = torch.cat([den_l, app_l], dim=-1)
        prod = sample_planeline_prod(plane, line, coords[m0], coords[m1],
                                     coords[VEC_MODE[i]])
        sigma = sigma + torch.sum(prod[:, :Rd[i]], dim=-1)
        app_parts.append(prod[:, Rd[i]:])
    return sigma, torch.cat(app_parts, dim=-1) @ field.basis


def _blurred(plane, line, mats):
    """The factors as float32, blurred by ``mats`` when given."""
    plane, line = plane.float(), line.float()
    if mats is None:
        return plane, line
    return (blur_ops.blur_plane(plane, mats[plane.shape[0]],
                                mats[plane.shape[1]]),
            blur_ops.blur_line(line, mats[line.shape[0]]))


def compute_density_feature(field: VMField, coords, blur_mats=None):
    """Density feature [N] at normalized coords (cx, cy, cz) from the
    density factors alone, blurred by ``blur_mats`` when given (the
    alpha-mask build and the probes unblurred; the two-stage appearance
    path's density)."""
    sigma = torch.zeros_like(coords[0])
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        plane, line = _blurred(field.density_planes[i],
                               field.density_lines[i], blur_mats)
        prod = sample_planeline_prod(plane, line, coords[m0], coords[m1],
                                     coords[VEC_MODE[i]])
        sigma = sigma + torch.sum(prod, dim=-1)
    return sigma


def compute_app_feature(field: VMField, coords, blur_mats=None):
    """Appearance features [N, app_dim] at normalized coords (cx, cy, cz)
    from the appearance factors alone (blurred by ``blur_mats`` when given),
    through one sample_planeline_prod (K3 in its backward) per axis."""
    feats = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        plane, line = _blurred(field.app_planes[i], field.app_lines[i],
                               blur_mats)
        feats.append(sample_planeline_prod(plane, line, coords[m0],
                                           coords[m1], coords[VEC_MODE[i]]))
    return torch.cat(feats, dim=-1) @ field.basis


def compute_density_grid(field: VMField, blur_mats=None):
    """Dense density-feature grid G [X, Y, Z]: the full rank expansion of
    the (blurred) density factors, sampled by ops/densify.py.  Every
    factor transform happens before interpolation, so G commutes with the
    factored sample; the port's configs hold none of the per-sample
    variants (convolve_positive_only) that would not."""
    spec = ("yxr,zr->xyz", "zxr,yr->xyz", "zyr,xr->xyz")
    G = None
    for i in range(3):
        plane, line = _blurred(field.density_planes[i],
                               field.density_lines[i], blur_mats)
        term = torch.einsum(spec[i], plane, line)
        G = term if G is None else G + term
    return G


def _abs(x):
    """|x| with JAX's derivative at 0, +1 (torch.abs's is 0): factors that
    are exactly zero still get the L1 term's push."""
    return torch.where(x >= 0, x, -x)


def density_L1(field: VMField):
    """Mean-abs sparsity on the density factors (planes and lines)."""
    total = 0.0
    for p in field.density_planes:
        total = total + torch.mean(_abs(p))
    for l in field.density_lines:
        total = total + torch.mean(_abs(l))
    return total


def _tv_plane(p):
    """TV of a [H, W, R] plane as the reference's TVLoss on [1, R, H, W]:
    2 * (mean dh^2 + mean dw^2)."""
    h_tv = torch.mean((p[1:, :, :] - p[:-1, :, :]) ** 2)
    w_tv = torch.mean((p[:, 1:, :] - p[:, :-1, :]) ** 2)
    return 2.0 * (h_tv + w_tv)


def tv_loss_density(field: VMField):
    return sum(_tv_plane(p) for p in field.density_planes) * 1e-2


def tv_loss_app(field: VMField):
    return sum(_tv_plane(p) for p in field.app_planes) * 1e-2


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
    tensoRF.py:274-295), computed in float32 and stored back in each
    factor's dtype."""
    res = [int(r) for r in res_target]
    return _with_factors(
        field,
        lambda i, p: resample.resize_plane(
            p.float(), res[MAT_MODE[i][1]], res[MAT_MODE[i][0]]).to(p.dtype),
        lambda i, l: resample.resize_line(l.float(),
                                          res[VEC_MODE[i]]).to(l.dtype))


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
