"""Volume renderer on the dense Euclidean path: ray sampling -> fused
factor sampling -> density -> compositing -> shading -> white background
(counterpart of joint_tensorf_tpu/render/renderer.py:222-651).

The path is the reference's with the TPU-layout alternatives off: no
dense-grid density (tpu.densify_density=false), no in-bbox or mask
compaction (tpu.bbox_compact=false, tpu.blur_mask_compact=false), dense
appearance over all samples gated by weight > thres (tpu.app_k=null).
With an alpha mask and no factor blur (the reference disables the mask
under blur), samples whose mask probe is 0 get no density: one probe per
``mask_stride`` consecutive samples when S is a multiple of it, else one
per sample (joint_tensorf_tpu/render/renderer.py:297-324, dense path).
Compositing goes through ops/composite.py (kernels K1/K2 on CUDA).

Gradients: sampling coordinates are differentiable w.r.t. ray origins and
directions, which is how pose gradients flow.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models import vm as vm_lib
from ..models.alpha_mask import AlphaMask, sample_alpha
from ..ops.composite import composite


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """White background and detached view directions, as every Euclidean
    BAT config sets them; samples are stratified in training only.
    ``mask_stride``: samples per alpha-mask probe (the JAX RenderConfig's
    fallback is 4; configs/base.yaml sets tpu.mask_stride = 2)."""
    n_samples: int
    is_train: bool = False
    mask_stride: int = 4


@dataclasses.dataclass(frozen=True)
class BlurSpec:
    mode: str            # "uniform-gaussian" | "uniform-average"
    kernel_size: int


def _mean3(x):
    """Mean of the 3 axes as sum * (1/3), the reference's rounding: the
    step size sets where samples fall, and one ulp moves samples that sit
    exactly on the box boundary in or out of it."""
    return torch.sum(x) * (1.0 / 3.0)


def sample_ray_axes(aabb, step_size, n_samples: int, centers, dirs,
                    near: float, far: float, stratified: bool, jitter=None,
                    generator: Optional[torch.Generator] = None):
    """Euclidean ray sampling in per-axis form.

    Returns ((wx, wy, wz) each [N,S], z_vals [N,S], in_bbox [N,S]).
    ``jitter`` [N,1]: pre-drawn stratified offsets; drawn from
    ``generator`` when None.
    """
    dirs_d = dirs.detach()
    o_d = centers.detach()
    vec = torch.where(dirs_d == 0, torch.full_like(dirs_d, 1e-6), dirs_d)
    rate_a = (aabb[1] - o_d) / vec
    rate_b = (aabb[0] - o_d) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(dim=-1),
                        near, far)
    steps = torch.arange(n_samples, dtype=centers.dtype,
                         device=centers.device)[None, :]
    if stratified:
        if jitter is None:
            jitter = torch.rand((centers.shape[0], 1), generator=generator,
                                dtype=centers.dtype, device=centers.device)
        steps = steps + jitter
    z_vals = t_min[:, None] + step_size * steps                  # [N,S]
    axes_w = []
    in_bbox = None
    for a in range(3):
        w = centers[:, a, None] + dirs[:, a, None] * z_vals      # [N,S]
        inb = (w >= aabb[0, a]) & (w <= aabb[1, a])
        in_bbox = inb if in_bbox is None else (in_bbox & inb)
        axes_w.append(w)
    return tuple(axes_w), z_vals, in_bbox


def render_rays(
    field: vm_lib.VMField,
    cfg: vm_lib.VMConfig,
    rcfg: RenderConfig,
    centers,                      # [N,3]
    dirs,                         # [N,3]
    near_far,                     # (near, far)
    blur: Optional[BlurSpec] = None,
    c2f_density: Any = None,      # world-space sigma of the density blur
    c2f_color: Any = None,
    view_pe_progress: Any = 1.0,
    fea_pe_progress: Any = 1.0,
    ray_jitter=None,              # [N,1] pre-drawn stratified offsets
    generator: Optional[torch.Generator] = None,
    alpha_mask: Optional[AlphaMask] = None,
    stats: Optional[dict] = None,
):
    """Returns (rgb_map [N,3], depth_map [N], opacity [N]).  A ``stats``
    dict receives the fractions of samples in the box ("inbbox_frac") and
    kept after the mask ("valid_frac"), as 0-d tensors."""
    n = centers.shape[0]
    S = rcfg.n_samples
    resolution = field.resolution()
    aabb = field.aabb.detach()
    aabb_size = aabb[1] - aabb[0]
    res_t = torch.as_tensor(resolution, dtype=aabb.dtype, device=aabb.device)
    near, far = float(near_far[0]), float(near_far[1])

    units = aabb_size / (res_t - 1)
    step_size = _mean3(units) * cfg.step_ratio
    axes_w, z_vals, valid = sample_ray_axes(
        aabb, step_size, S, centers, dirs, near, far, rcfg.is_train,
        jitter=ray_jitter, generator=generator)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.zeros_like(z_vals[:, :1])], -1)
    if stats is not None:
        stats["inbbox_frac"] = valid.float().mean()
    if alpha_mask is not None and blur is None:
        stride = rcfg.mask_stride if S % max(rcfg.mask_stride, 1) == 0 else 1
        probe = tuple(w.detach()[:, ::stride].reshape(-1) for w in axes_w)
        group_alive = sample_alpha(alpha_mask, probe).reshape(
            n, S // stride) > 0
        valid = valid & torch.repeat_interleave(group_alive, stride, dim=1)
    if stats is not None:
        stats["valid_frac"] = valid.float().mean()

    d_mats = c_mats = None
    if blur is not None:
        grid_scale = _mean3(res_t / aabb_size)
        dk = vm_lib.c2f_kernel(blur.mode, c2f_density, blur.kernel_size,
                               grid_scale)
        ck = vm_lib.c2f_kernel(blur.mode, c2f_color, blur.kernel_size,
                               grid_scale)
        d_mats = vm_lib.make_blur_mats(dk, resolution)
        c_mats = vm_lib.make_blur_mats(ck, resolution)

    coords = tuple(vm_lib.normalize_coord(w, aabb[:, a]).reshape(-1)
                   for a, w in enumerate(axes_w))
    mlp_viewdirs = dirs.detach()[:, None, :].expand(n, S, 3)

    sigma_feature, app_feat = vm_lib.compute_fused_features(
        field, cfg, coords, d_mats=d_mats, c_mats=c_mats)
    sigma = vm_lib.feature2density(cfg, sigma_feature.reshape(n, S))
    sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
    alpha = 1.0 - torch.exp(-sigma * dists * cfg.distance_scale)

    rgb = field.shading(mlp_viewdirs.reshape(-1, 3), app_feat,
                        view_pe_progress, fea_pe_progress).reshape(n, S, 3)
    rgb_map, depth_map, acc_map, _ = composite(
        alpha, rgb, z_vals, cfg.raymarch_weight_thres)

    rgb_map = torch.clamp(rgb_map + (1.0 - acc_map[..., None]), 0.0, 1.0)

    depth_map = depth_map + (1.0 - acc_map) * dirs[..., -1]
    depth_map = (depth_map - near + 0.05).detach()
    return rgb_map, depth_map, acc_map
