"""VM- or CP-decomposed tensorial radiance field
(counterpart of joint_tensorf_tpu/models/vm.py: the factor samples, the
dense grid, the regularisers and the shape transitions).

The field is an nn.Module: channels-last factor grids ([H, W, R] planes,
[D, R] lines; CP, ``decomposition`` "CP", has lines only and its basis
maps R, not 3R, components), the appearance basis, the shading head
(VMConfig.shading_mode, models/shading.py), and the scene box ``aabb`` as
a buffer.

BAT's blur-path variants (the reference's bateRF.py:52-89) act on the
density factors before their blur: component_wise_feature2density (the
activation on planes and lines; the renderer then applies none after the
sample), plane_feature2density (on the planes), abs_components (|.| on
both); convolve_plane_only leaves the density lines unblurred;
convolve_positive_only samples the blurred plane and line apart and, where
the blurred line sample is negative, takes the sharp plane's sample (or,
with ignore_negative_split, zero) instead.  The fused sample and the dense
grid run only where they compute the same function (can_fuse_features,
can_densify).  The density activation is softplus or relu
(VMConfig.fea2dense); the TV terms of the LLFF configs are tv_loss_density
and tv_loss_app.  The box gets no gradient: pose and plane
gradients flow through the sampling coordinates, never into the box
(joint_tensorf_tpu/render/renderer.py:243-250).

Axis conventions: matMode=[[0,1],[0,2],[1,2]], vecMode=[2,1,0]; plane i is
[H=res[m1], W=res[m0], R_i], line i is [D=res[vec_i], R_i].

A shape transition (upsample, shrink) builds a new VMField around new
factor tensors and keeps the basis and shading head; nothing is replaced
in place under autograd.

Under the comp layout (parallel/, ``tpu.mesh_axes`` with a ``comp`` axis
of size C) the field's ``comp`` is the rank's mesh: it holds the
contiguous block of 1/C of every factor's components (init_vm draws the
whole factor and keeps the block, so a sharded run starts from the
unsharded run's numbers), and the feature functions reduce inside.  Each
computes its partial sum on its components, the appearance's local
components times the matching rows of the replicated basis, and the sum
meets in one all-reduce over the comp group; the sample coordinates enter
through copy_to_comp, whose backward sums the coordinate gradient's
parts (parallel/sharding.py).  So every caller (the renderer, the alpha
mask, the budget probes, evaluation, the test-time steps) gets the whole
feature and changes nowhere else.  The regularisers become local sums
over the global element counts (their comp ranks' terms add up to the
unsharded term); upsample and shrink act per component and stay local.
``comp`` is None when the field is not sharded.

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
from ..ops import densify, lane_grid, resample
from ..ops.kernels import average_kernel, gaussian_kernel
from ..ops.sampling import (sample_line, sample_plane, sample_planeline_prod,
                             sample_planeline_prod_sum)
from ..parallel import sharding
from .shading import make_head

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
# the coordinates axis i's plane (u -> W, v -> H) and line (w) read
AXES = tuple((m0, m1, v) for (m0, m1), v in zip(MAT_MODE, VEC_MODE))


@dataclasses.dataclass(frozen=True)
class VMConfig:
    """Static field configuration (the JAX package's VMConfig)."""
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
    shading_mode: str = "MLP_Fea"            # models/shading.HEAD_NAMES
    fea2dense: str = "softplus"              # or "relu"
    pos_pe: int = 2
    decomposition: str = "VM"                # or "CP"
    abs_components: bool = False
    component_wise_feature2density: bool = False
    plane_feature2density: bool = False
    convolve_plane_only: bool = False
    convolve_positive_only: bool = False
    ignore_negative_split: bool = False


class VMField(nn.Module):
    """Learnable field state: factor grids (this rank's component block
    under ``comp``, the rank's mesh), basis, shading head, and the
    ``aabb`` buffer."""

    def __init__(self, density_planes, density_lines, app_planes, app_lines,
                 basis, shading: nn.Module, aabb, comp=None):
        super().__init__()
        self.comp = comp
        P = nn.ParameterList
        self.density_planes = P([nn.Parameter(t) for t in density_planes])
        self.density_lines = P([nn.Parameter(t) for t in density_lines])
        self.app_planes = P([nn.Parameter(t) for t in app_planes])
        self.app_lines = P([nn.Parameter(t) for t in app_lines])
        self.basis = nn.Parameter(basis)
        self.shading = shading
        self.register_buffer("aabb", aabb.reshape(2, 3))

    def resolution(self) -> list[int]:
        """[res_x, res_y, res_z]: W and H of plane 0, D of line 0; a CP
        field's from its lines (line i lies along axis VEC_MODE[i])."""
        if len(self.density_planes):
            return [self.density_planes[0].shape[1],
                    self.density_planes[0].shape[0],
                    self.density_lines[0].shape[0]]
        return [self.density_lines[2].shape[0],
                self.density_lines[1].shape[0],
                self.density_lines[0].shape[0]]

    def is_factor(self, name: str) -> bool:
        """Factor grids train at lr_index, basis and shading at lr_basis."""
        return name.split(".")[0] in ("density_planes", "density_lines",
                                      "app_planes", "app_lines")


def factor_block(comp, group: str, i: int, n: int) -> slice:
    """This rank's contiguous block of the ``n`` components of axis ``i``
    of a factor group ("density_*" or "app_*"): all of them without
    ``comp``; a count that does not divide by the comp axis raises
    ValueError naming its config key."""
    if comp is None:
        return slice(None)
    key = ("density_components" if group.startswith("density")
           else "color_components")
    return sharding.comp_block(n, comp, f"arch.tensorf.{key}[{i}]")


def init_vm(cfg: VMConfig, resolution: Sequence[int], aabb,
            generator: torch.Generator, init_scale: float = 0.1,
            init_bias: float = 0.0, device=None, init_density: bool = True,
            init_app: bool = True, init_basis: bool = True,
            prev: VMField | None = None, comp=None) -> VMField:
    """Factors |bias + scale*N(0,1)| in cfg.factor_dtype (CP lines
    scale*N(0,1), no abs and no bias, and no planes), basis
    U(+-1/sqrt(fan_in)), shading with nn.Linear's default init, drawn from
    ``generator``.  With ``prev`` (the reference's reset_on_last_upsample,
    joint_tensorf_tpu/models/vm.py:106-151), the groups not re-initialised
    are carried over from it unchanged, and so is the shading head (and
    its ``comp``).  Under ``comp`` (the rank's mesh) each factor is drawn
    whole and this rank's component block kept."""
    res = list(resolution)
    fdt = getattr(torch, cfg.factor_dtype)
    comp = prev.comp if prev is not None and comp is None else comp

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    cp = cfg.decomposition == "CP"

    def one_svd(n_comp, group):
        planes, lines = [], []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            blk = factor_block(comp, group, i, n_comp[i])
            if not cp:
                p = normal((res[m1], res[m0], n_comp[i]))
                planes.append(torch.abs(init_bias + init_scale * p)[
                    ..., blk].to(fdt).contiguous())
            l = normal((res[VEC_MODE[i]], n_comp[i]))
            lines.append((init_scale * l if cp else torch.abs(
                init_bias + init_scale * l))[..., blk].to(fdt).contiguous())
        return planes, lines

    d_planes, d_lines = one_svd(cfg.density_n_comp, "density")
    a_planes, a_lines = one_svd(cfg.app_n_comp, "app")
    basis_in = cfg.app_n_comp[0] if cp else sum(cfg.app_n_comp)
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
    return VMField(d_planes, d_lines, a_planes, a_lines, basis, shading, aabb,
                   comp=comp)


def make_shading(cfg: VMConfig, device=None,
                 generator: torch.Generator | None = None) -> nn.Module:
    """The config's shading head, drawn from ``generator``."""
    return make_head(cfg.shading_mode, cfg.app_dim, cfg.view_pe, cfg.pos_pe,
                     cfg.fea_pe, cfg.hidden, device=device,
                     generator=generator)


def normalize_coord(xyz, aabb):
    """World -> [-1,1]; aabb [2, 3] for [..., 3] points or [2] for one axis."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def coord_axes(coords):
    """(cx, cy, cz) from a tuple of [N] tensors or an [N, 3] tensor (the
    feature functions take the tuple)."""
    if isinstance(coords, (tuple, list)):
        return coords[0], coords[1], coords[2]
    return coords[:, 0], coords[:, 1], coords[:, 2]


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


def can_fuse_features(cfg: VMConfig) -> bool:
    """Whether density and appearance can share one fused factor sample:
    VM factors with no per-component activation and no per-sample
    blurred / sharp mix."""
    return (cfg.decomposition == "VM"
            and not cfg.component_wise_feature2density
            and not cfg.plane_feature2density
            and not cfg.abs_components
            and not cfg.convolve_positive_only)


def can_densify(cfg: VMConfig) -> bool:
    """Whether the density can be read from the dense grid: every factor
    transform (activation variants, blur) happens before interpolation and
    commutes with the expansion; only convolve_positive_only mixes blurred
    and sharp factors per sample."""
    return not cfg.convolve_positive_only


def _blurred(plane, line, mats, blur_line: bool = True):
    """The factors as float32, blurred by ``mats`` when given (the line
    only with ``blur_line``)."""
    plane, line = plane.float(), line.float()
    if mats is None:
        return plane, line
    plane = blur_ops.blur_plane(plane, mats[plane.shape[0]],
                                mats[plane.shape[1]])
    if blur_line:
        line = blur_ops.blur_line(line, mats[line.shape[0]])
    return plane, line


def _density_variant(cfg: VMConfig, plane, line):
    """The activation variant on a density plane and line, in their
    storage dtype (as JAX applies it to the stored factors)."""
    if cfg.component_wise_feature2density:
        return feature2density(cfg, plane), feature2density(cfg, line)
    if cfg.plane_feature2density:
        return feature2density(cfg, plane), line
    if cfg.abs_components:
        return _abs(plane), _abs(line)
    return plane, line


def _density_factors(field: VMField, cfg: VMConfig, i: int, mats):
    """Density plane and line of axis i as float32, varied and blurred
    (the line not under convolve_plane_only), and the varied plane
    unblurred."""
    plane, line = _density_variant(cfg, field.density_planes[i],
                                   field.density_lines[i])
    sharp = plane.float()
    plane, line = _blurred(plane, line, mats,
                           blur_line=not cfg.convolve_plane_only)
    return plane, line, sharp


def _comp_coords(field: VMField, coords):
    """The coordinates as the factors read them: under ``comp`` through
    copy_to_comp, whose backward sums the comp ranks' parts."""
    if field.comp is None:
        return coords
    return sharding.copy_to_comp(field.comp, tuple(coords))


def _comp_sum(field: VMField, x):
    """The whole feature from this rank's partial ``x`` (reduce_comp under
    ``comp``)."""
    return x if field.comp is None else sharding.reduce_comp(field.comp, x)


def basis_rows(field: VMField, cfg: VMConfig):
    """The basis rows of this rank's appearance components: the whole
    basis unless ``comp``; else each axis's block of its rows (CP: of the
    one group's)."""
    if field.comp is None:
        return field.basis
    counts = cfg.app_n_comp[:1] if cfg.decomposition == "CP" \
        else cfg.app_n_comp
    rows, at = [], 0
    for i, n in enumerate(counts):
        blk = factor_block(field.comp, "app", i, n)
        rows.append(field.basis[at + blk.start:at + blk.stop])
        at += n
    return torch.cat(rows) if len(rows) > 1 else rows[0]


def compute_fused_features(field: VMField, cfg: VMConfig, coords,
                           d_mats=None, c_mats=None):
    """Density and appearance features from ONE fused factor sample per
    axis: density and appearance grids are concatenated channel-wise
    ([H, W, Rd+Ra]) after their own blurs, sampled once, and split (only
    where can_fuse_features).

    coords: (cx, cy, cz) tuple of [N] tensors in [-1,1].
    Returns (sigma_feature [N], app_feature [N, app_dim]).
    """
    if not can_fuse_features(cfg):
        raise ValueError("compute_fused_features: the config's variants "
                         "need the separate samples")
    coords = _comp_coords(field, coords)
    sigma = torch.zeros_like(coords[0])
    app_parts = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        den_p, den_l, _ = _density_factors(field, cfg, i, d_mats)
        app_p, app_l = _blurred(field.app_planes[i], field.app_lines[i],
                                c_mats)
        plane = torch.cat([den_p, app_p], dim=-1)
        line = torch.cat([den_l, app_l], dim=-1)
        prod = sample_planeline_prod(plane, line, coords[m0], coords[m1],
                                     coords[VEC_MODE[i]])
        rd = den_p.shape[-1]
        sigma = sigma + torch.sum(prod[:, :rd], dim=-1)
        app_parts.append(prod[:, rd:])
    app = torch.cat(app_parts, dim=-1) @ basis_rows(field, cfg)
    if field.comp is None:
        return sigma, app
    both = _comp_sum(field, torch.cat([sigma[:, None], app], dim=-1))
    return both[:, 0], both[:, 1:]


def _cp_feature(lines, cfg: VMConfig, coords, blur_mats, density: bool):
    """CP: the product of the three (blurred) line samples [N, R], each
    line activated first for a component-wise density.  The samples are
    plain gathers under autograd, as JAX's are."""
    prod = None
    for i in range(3):
        line = lines[i]
        if density and cfg.component_wise_feature2density:
            line = feature2density(cfg, line)
        line = line.float()
        if blur_mats is not None:
            line = blur_ops.blur_line(line, blur_mats[line.shape[0]])
        s = sample_line(line, coords[VEC_MODE[i]])
        prod = s if prod is None else prod * s
    return prod


def density_sample_skips_dead(cfg: VMConfig, blurred: bool) -> bool:
    """Whether compute_density_feature takes the summed plane x line
    sample (K6 on the card), which evaluates the ``live`` slots alone: VM
    factors, and not convolve_positive_only's split under the blur."""
    return cfg.decomposition == "VM" and not (
        blurred and cfg.convolve_positive_only)


def compute_density_feature(field: VMField, cfg: VMConfig, coords,
                            blur_mats=None, live=None):
    """Density feature [N] at normalized coords (cx, cy, cz) from the
    density factors alone, varied and blurred by ``blur_mats`` when given
    (the alpha-mask build and the probes unblurred).  Under the blur with
    convolve_positive_only the plane and line are sampled apart by plain
    gathers; otherwise the three axes' plane x line products in one
    sample_planeline_prod_sum (K6 on the card), which evaluates only the
    slots ``live`` [N] bool marks (None: all) and gives 0 at the others
    (density_sample_skips_dead).  CP and the split path evaluate every
    slot and take no ``live``."""
    coords = _comp_coords(field, coords)
    if cfg.decomposition == "CP":
        return _comp_sum(field, torch.sum(_cp_feature(
            field.density_lines, cfg, coords, blur_mats, density=True),
            dim=-1))
    factors = [_density_factors(field, cfg, i, blur_mats) for i in range(3)]
    if density_sample_skips_dead(cfg, blur_mats is not None):
        return _comp_sum(field, sample_planeline_prod_sum(
            [f[0] for f in factors], [f[1] for f in factors], coords, AXES,
            live))
    sigma = torch.zeros_like(coords[0])
    for (plane, line, sharp), (m0, m1, vec) in zip(factors, AXES):
        u, v, w = coords[m0], coords[m1], coords[vec]
        p = sample_plane(plane, u, v)
        l = sample_line(line, w)
        pos = l.detach() >= 0
        if cfg.ignore_negative_split:
            p = p * pos
        else:
            p = torch.where(pos, p, sample_plane(sharp, u, v))
        sigma = sigma + torch.sum(p * l, dim=-1)
    return _comp_sum(field, sigma)


def compute_app_feature(field: VMField, cfg: VMConfig, coords,
                        blur_mats=None):
    """Appearance features [N, app_dim] at normalized coords (cx, cy, cz)
    from the appearance factors alone (blurred by ``blur_mats`` when given,
    planes and lines alike): one sample_planeline_prod (K3 in its
    backward) per axis, or CP's line product."""
    coords = _comp_coords(field, coords)
    if cfg.decomposition == "CP":
        return _comp_sum(field, _cp_feature(
            field.app_lines, cfg, coords, blur_mats, density=False)
            @ basis_rows(field, cfg))
    feats = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        plane, line = _blurred(field.app_planes[i], field.app_lines[i],
                               blur_mats)
        feats.append(sample_planeline_prod(plane, line, coords[m0],
                                           coords[m1], coords[VEC_MODE[i]]))
    return _comp_sum(field, torch.cat(feats, dim=-1) @ basis_rows(field, cfg))


def compute_density_grid(field: VMField, cfg: VMConfig, blur_mats=None):
    """Dense density-feature grid G [X, Y, Z]: the full rank expansion of
    the (varied, blurred) density factors, sampled by ops/densify.py.
    Every factor transform happens before interpolation, so G commutes
    with the factored sample (not so under convolve_positive_only:
    can_densify).  CP: the xr,yr,zr->xyz product of the three lines.
    Under ``comp`` the grid of this rank's components: a partial grid
    (sample_density_grid sums its samples)."""
    if cfg.decomposition == "CP":
        lines = []
        for i in range(3):
            line = field.density_lines[i]
            if cfg.component_wise_feature2density:
                line = feature2density(cfg, line)
            line = line.float()
            if blur_mats is not None:
                line = blur_ops.blur_line(line, blur_mats[line.shape[0]])
            lines.append(line)
        # line i lies along axis VEC_MODE[i] = (z, y, x)
        return torch.einsum("xr,yr,zr->xyz", lines[2], lines[1], lines[0])
    spec = ("yxr,zr->xyz", "zxr,yr->xyz", "zyr,xr->xyz")
    G = None
    for i in range(3):
        plane, line, _ = _density_factors(field, cfg, i, blur_mats)
        term = torch.einsum(spec[i], plane, line)
        G = term if G is None else G + term
    return G


def sample_density_grid(field: VMField, cfg: VMConfig, coords,
                        blur_mats=None, row_dtype: str = "float32"):
    """Density feature [N] read from the dense grid (ops/densify.py) at
    coords (cx, cy, cz) in [-1, 1], its corner rows in ``row_dtype``.
    Under ``comp`` every rank builds the partial grid of its components
    and samples it, and the [N] samples are reduced: the grid is linear in
    the components, so this is the unsharded function (with bf16 rows each
    partial row is rounded before the sum), and one all-reduce moves N
    floats instead of the X*Y*Z grid."""
    coords = _comp_coords(field, coords)
    G = compute_density_grid(field, cfg, blur_mats=blur_mats)
    return _comp_sum(field, densify.sample_packed_grid(
        densify.pack_corners(G), coords, row_dtype=row_dtype))


def compute_lane_density_grid(field: VMField, cfg: VMConfig, blur_mats=None):
    """The density grid lane-packed, [X, Y, Zb, 128] (ops/lane_grid.py):
    VM straight from the (varied, blurred) density factors through
    build_lane_grid_vm; CP as pack_lane_grid(compute_density_grid).  No
    entry point calls it, in either package.  A field holding a block of
    the components (the comp layout) raises ValueError: its grid would be
    a partial one, and no caller sums such grids."""
    if field.comp is not None:
        raise ValueError("compute_lane_density_grid: the field holds "
                         f"1/{field.comp.comp} of the components (comp "
                         f"layout); the lane grid needs all of them")
    if cfg.decomposition == "CP":
        return lane_grid.pack_lane_grid(
            compute_density_grid(field, cfg, blur_mats=blur_mats))
    factors = [_density_factors(field, cfg, i, blur_mats)[:2]
               for i in range(3)]
    return lane_grid.build_lane_grid_vm([p for p, _ in factors],
                                        [line for _, line in factors])


def _abs(x):
    """|x| with JAX's derivative at 0, +1 (torch.abs's is 0): factors that
    are exactly zero still get the L1 term's push."""
    return torch.where(x >= 0, x, -x)


def _comp_share(field: VMField, total):
    """A mean over this rank's components as its share of the mean over
    all of them (the blocks are equal): / C under ``comp``."""
    return total if field.comp is None else total / field.comp.comp


def density_L1(field: VMField):
    """Mean-abs sparsity on the density factors (planes and lines; a CP
    field's lines); under ``comp`` this rank's share."""
    total = 0.0
    for p in field.density_planes:
        total = total + torch.mean(_abs(p))
    for l in field.density_lines:
        total = total + torch.mean(_abs(l))
    return _comp_share(field, total)


def _vector_diffs(lines, comp=None):
    """Mean |off-diagonal| of the line factors' Gram matrices (the whole
    lines, gathered under ``comp``)."""
    total = 0.0
    for l in lines:                       # [D, R]
        l = l.float() if comp is None else sharding.gather_comp(
            comp, l).float()
        gram = l.T @ l
        R = gram.shape[0]
        off = gram * (1.0 - torch.eye(R, dtype=gram.dtype,
                                      device=gram.device))
        total = total + torch.sum(torch.abs(off)) / (R * (R - 1))
    return total


def vector_comp_diffs(field: VMField):
    """The line components' orthogonality diagnostic (the reference's
    tensoRF.py:198-210): density and appearance lines."""
    return (_vector_diffs(field.density_lines, field.comp)
            + _vector_diffs(field.app_lines, field.comp))


def _tv_plane(p):
    """TV of a [H, W, R] plane as the reference's TVLoss on [1, R, H, W]:
    2 * (mean dh^2 + mean dw^2)."""
    h_tv = torch.mean((p[1:, :, :] - p[:-1, :, :]) ** 2)
    w_tv = torch.mean((p[:, 1:, :] - p[:, :-1, :]) ** 2)
    return 2.0 * (h_tv + w_tv)


def _tv_line(l):
    return 2.0 * torch.mean((l[1:, :] - l[:-1, :]) ** 2)


def tv_loss_density(field: VMField):
    """TV of the density planes x 1e-2 (a CP field's lines x 1e-3); under
    ``comp`` this rank's share."""
    if not len(field.density_planes):
        return _comp_share(field, sum(_tv_line(l) for l in
                                      field.density_lines) * 1e-3)
    return _comp_share(field, sum(_tv_plane(p) for p in
                                  field.density_planes) * 1e-2)


def tv_loss_app(field: VMField):
    """TV of the appearance planes x 1e-2 (a CP field's lines x 1e-3);
    under ``comp`` this rank's share."""
    if not len(field.app_planes):
        return _comp_share(field, sum(_tv_line(l) for l in
                                      field.app_lines) * 1e-3)
    return _comp_share(field, sum(_tv_plane(p) for p in
                                  field.app_planes) * 1e-2)


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
                   field.aabb if aabb is None else aabb, comp=field.comp)


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
