"""Volume renderer: ray sampling (Euclidean or NDC) -> alpha-mask gate ->
sample compaction -> density (factored or dense grid) -> compositing ->
appearance (dense or two-stage) -> background (counterpart of
joint_tensorf_tpu/render/renderer.py:166-651).

The ``tpu:`` alternatives of the JAX renderer, all but the first of them
RenderConfig fields:

* the alpha-mask gate: a mask passed to render_rays gates the samples,
  one probe per ``mask_stride`` consecutive samples when S is a multiple
  of it, else one per sample.  The JAX RenderConfig's use_alpha_mask and
  mask_with_blur are folded into which mask the caller passes: under the
  factor blur the trainer passes the mask dilated by the blur's support,
  or none;
* sample compaction (``compact_k`` < S): each ray keeps K of its S slots,
  the first live ones in march order, chosen by one top-k on a score that
  is unique per slot.  Three Euclidean forms: probe groups under the
  mask, probe groups with the in-bbox gate alone (no mask in use), and
  single samples (S not a multiple of the stride).  z and dists of a kept
  slot are recomputed from its index, z = t_min + step * (i + jitter) and
  dists = step (0 at i = S - 1), and the coordinates from z, so pose
  gradients flow through o + d * z, not through a gather.  Under NDC the
  kept slots' z, dists (detached) and points are gathered;
* the dense-grid density (``densify_density``, ops/densify.py), its
  corner rows read in bfloat16 with ``densify_dtype`` "bfloat16" (the JAX
  renderer's lane branch, renderer.py:465-477).  The option allows the
  grid; it is built only where the summed factor sample (K6), the same
  function, does not apply or the rows are read in bfloat16
  (density_route);
* ``stop_coord_grad``: the sample coordinates are detached before the
  factor samples and the dense-grid read (TensoRF, whose poses are not
  optimised: the backward then computes no coordinate derivatives);
* the two-stage appearance (``app_k``): only the app_k samples of largest
  weight among those past the weight gate are shaded.

Under the comp layout (models/vm.py) the field's feature functions reduce
inside, and the dense grid is read by vm.sample_density_grid: each rank
samples the partial grid of its components and the samples are summed,
which moves N floats a step where summing the grid would move X*Y*Z
(64M at 400^3).  Everything after the features is computed identically on
every rank of a comp group; with ``stats`` the two-stage selection is
checked equal over the comp group (one checksum all-reduce).

The field's own options choose the density path as JAX's renderer does
(renderer.py:449-459): the dense grid only where vm.can_densify, the fused
sample only where vm.can_fuse_features, neither (nor the two-stage
appearance) when the head predicts the density (``mlp_predict_density``,
MLP_Fea_WeakView_Density); a component-wise activated feature gets no
activation after the sample.  The spans ``jt.render.density.grid`` and
``jt.render.density.factored`` name the route a step took.  Every head
gets the sample points and view directions, detached unless
``detach_xyz`` / ``detach_viewdirs`` is off.

``ndc``: the rays are in NDC (geometry/ndc.py); samples sit at
linspace(near, far, S) with a stratified offset per sample, distances
are scaled by |d| and the view directions normalised
(sample_ray_ndc).  ``white_bg`` false: in training a coin (pre-drawn, or
drawn from the generator) adds the white background to every ray or to
none, at evaluation nothing is added.

Compositing goes through ops/composite.py (kernels K1/K2 on CUDA) in every
branch; JAX composites the predict-density and non-fused branches with its
plain cumprod, the same function.  Under ``mlp_predict_density`` the
colour is gated by the sample's validity: K1 gets the colours
pre-multiplied by ``valid`` and no threshold (thres -inf).  In the two-stage branch K1 gives weights, depth and opacity (its
rgb input is zero), the selected weights are gathered from its weights,
and K2 receives their gradient as its g_weights: rgb = sum w_sel * rgb_sel
* gate_sel, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..geometry.ndc import grad_rescale
from ..models import vm as vm_lib
from ..models.alpha_mask import AlphaMask, sample_alpha
from ..ops.composite import composite
from ..parallel import sharding
from ..utils import tracing


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Samples are stratified in training when ``stratified``; the shading
    head gets the view directions and the sample points detached unless
    ``detach_viewdirs`` / ``detach_xyz`` is off; with
    ``mlp_predict_density`` the head gives the density feature too (no
    dense grid, fused sample or two-stage appearance then).
    ``mask_stride``: samples per alpha-mask probe (the JAX RenderConfig's
    fallback is 4; configs/base.yaml sets tpu.mask_stride = 2).  The JAX
    RenderConfig's densify_impl has no counterpart: its two layouts are one
    sampler here (ops/densify.py)."""
    n_samples: int
    is_train: bool = False
    stratified: bool = True
    mask_stride: int = 4
    compact_k: Optional[int] = None
    densify_density: bool = False
    densify_dtype: str = "float32"
    app_k: Optional[int] = None
    stop_coord_grad: bool = False
    white_bg: bool = True
    ndc: bool = False
    ndc_near_plane: float = 1.0
    ndc_simulate_euclid_sample: bool = False
    ndc_simulate_euclid_depth: bool = False
    detach_viewdirs: bool = True
    detach_xyz: bool = True
    mlp_predict_density: bool = False


@dataclasses.dataclass(frozen=True)
class BlurSpec:
    mode: str            # "uniform-gaussian" | "uniform-average"
    kernel_size: int


def _mean3(x):
    """Mean of the 3 axes as sum * (1/3), the reference's rounding: the
    step size sets where samples fall, and one ulp moves samples that sit
    exactly on the box boundary in or out of it."""
    return torch.sum(x) * (1.0 / 3.0)


def step_size(aabb, resolution, step_ratio: float):
    """Ray-march step: the mean grid cell edge times step_ratio.
    ``resolution``: a list, or a tensor on the box's device
    (VMField.resolution_tensor, which a step reads without a host copy)."""
    res_t = (resolution if isinstance(resolution, torch.Tensor) else
             torch.as_tensor(resolution, dtype=aabb.dtype,
                             device=aabb.device))
    return _mean3((aabb[1] - aabb[0]) / (res_t - 1)) * step_ratio


def sample_ray(aabb, step_size, n_samples: int, centers, dirs, near: float,
               far: float, stratified: bool, jitter=None,
               generator: Optional[torch.Generator] = None):
    """Euclidean ray sampling with the points stacked: (pts [N,S,3],
    z_vals [N,S], in_bbox [N,S]); sample_ray_axes' arguments."""
    axes_w, z_vals, in_bbox, _ = sample_ray_axes(
        aabb, step_size, n_samples, centers, dirs, near, far, stratified,
        jitter=jitter, generator=generator)
    return torch.stack(axes_w, dim=-1), z_vals, in_bbox


def sample_ray_axes(aabb, step_size, n_samples: int, centers, dirs,
                    near: float, far: float, stratified: bool, jitter=None,
                    generator: Optional[torch.Generator] = None):
    """Euclidean ray sampling in per-axis form.

    Returns ((wx, wy, wz) each [N,S], z_vals [N,S], in_bbox [N,S],
    (t_min [N], jitter [N,1])); the jitter is 0 when not stratified.
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
    else:
        jitter = torch.zeros((centers.shape[0], 1), dtype=centers.dtype,
                             device=centers.device)
    z_vals = t_min[:, None] + step_size * steps                  # [N,S]
    axes_w = tuple(centers[:, a, None] + dirs[:, a, None] * z_vals
                   for a in range(3))                            # [N,S] each
    return axes_w, z_vals, _in_bbox(axes_w, aabb), (t_min, jitter)


def _linspace(start, stop, num: int, device):
    """jnp.linspace in float32 as JAX computes it: start * (1 - i / (num -
    1)) + stop * (i / (num - 1)), then ``stop`` itself.  Host ends are
    filled on the device (torch.full), not copied from the host, which
    would synchronise it; 0-d float32 tensors are read as they are."""
    start, stop = (v if isinstance(v, torch.Tensor) else torch.full(
        (), v, dtype=torch.float32, device=device) for v in (start, stop))
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([start * (1 - t) + stop * t, stop[None]]), start, stop


def sample_ray_ndc(aabb, n_samples: int, centers, dirs, near: float,
                   far: float, stratified: bool, ndc_near_plane: float,
                   simulate_euclid_sample: bool,
                   simulate_euclid_depth: bool, jitter=None,
                   generator: Optional[torch.Generator] = None):
    """NDC ray sampling: S samples at linspace(near, far), each offset by
    its own stratified jitter [N,S] (pre-drawn, or drawn from
    ``generator``) times (far - near) / S; with simulate_euclid_sample the
    points' depths carry the Euclidean depth's gradient scale
    (grad_rescale), with simulate_euclid_depth z is that depth.
    Returns ((wx, wy, wz) each [N,S], z_vals [N,S], in_bbox [N,S])."""
    n = centers.shape[0]
    line, start, stop = _linspace(near, far, n_samples, centers.device)
    interpx = line[None, :].expand(n, n_samples)
    if stratified:
        if jitter is None:
            jitter = torch.rand((n, n_samples), generator=generator,
                                dtype=centers.dtype, device=centers.device)
        interpx = interpx + jitter * ((stop - start) / n_samples)
    ndc_depth = 2 * ndc_near_plane / (1 - ndc_near_plane - interpx)
    z_for_pts = (grad_rescale(interpx, ndc_depth) if simulate_euclid_sample
                 else interpx)
    axes_w = tuple(centers[:, a, None] + dirs[:, a, None] * z_for_pts
                   for a in range(3))
    z_vals = ndc_depth if simulate_euclid_depth else interpx
    return axes_w, z_vals, _in_bbox(axes_w, aabb)


def _in_bbox(axes_w, aabb):
    ok = None
    for a, w in enumerate(axes_w):
        inb = (w >= aabb[0, a]) & (w <= aabb[1, a])
        ok = inb if ok is None else (ok & inb)
    return ok


def _first_k(valid, K: int):
    """The first K slots of each row with ``valid`` set, in index order,
    then the first unset ones: (indices [n, K], slot is valid [n, K]).  The
    score 2L - i / L - i is unique per slot, so top-k returns march order."""
    L = valid.shape[1]
    i = torch.arange(L, device=valid.device)
    score = torch.where(valid, 2 * L - i, L - i)
    top = torch.topk(score, K, dim=-1, sorted=True).indices
    n_valid = valid.sum(dim=-1, keepdim=True)
    return top, torch.arange(K, device=valid.device)[None, :] < n_valid


def density_route(rcfg, cfg: vm_lib.VMConfig, blurred: bool) -> str:
    """How render_rays computes the density feature on a field of ``cfg``
    under RenderConfig (or StepConfig) ``rcfg``: "head"
    (mlp_predict_density: the head gives it), "grid" (the dense grid,
    ops/densify.py), "fused" (one fused sample with the appearance) or
    "factored" (compute_density_feature: K6 where
    vm.density_sample_skips_dead).  ``densify_density`` allows the grid
    where vm.can_densify; it is built only where the summed factor sample
    does not apply (CP) or its rows are read in bfloat16, since elsewhere
    K6 costs less at every shape a shipped configuration reaches (PERF.md
    §6).  The fused sample runs only where no grid is allowed: under an
    allowed grid the density goes to the summed factor sample, which keeps
    the density's gradient out of the fused sample's row scatter."""
    if rcfg.mlp_predict_density:
        return "head"
    if rcfg.densify_density and vm_lib.can_densify(cfg):
        if (not vm_lib.density_sample_skips_dead(cfg, blurred)
                or rcfg.densify_dtype == "bfloat16"):
            return "grid"
        return "factored"
    if rcfg.app_k is None and vm_lib.can_fuse_features(cfg):
        return "fused"
    return "factored"


@tracing.spanned("render")
def render_rays(
    field: vm_lib.VMField,
    cfg: vm_lib.VMConfig,
    rcfg: RenderConfig,
    centers,                      # [N,3]
    dirs,                         # [N,3]
    near_far,                     # (near, far): floats or 0-d tensors
    blur: Optional[BlurSpec] = None,
    c2f_density: Any = None,      # world-space sigma of the density blur
    c2f_color: Any = None,
    view_pe_progress: Any = 1.0,
    fea_pe_progress: Any = 1.0,
    ray_jitter=None,              # [N,1] Euclidean / [N,S] NDC offsets
    generator: Optional[torch.Generator] = None,
    alpha_mask: Optional[AlphaMask] = None,
    stats: Optional[dict] = None,
    bg_coin=None,                 # pre-drawn background coin (0 or 1)
):
    """Returns (rgb_map [N,3], depth_map [N], opacity [N]).  A given
    ``alpha_mask`` gates the samples, with or without the blur.  A ``stats``
    dict receives, as 0-d tensors, the fractions of the S sample slots in
    the box ("inbbox_frac"), live after the mask ("valid_frac"), kept by
    the compaction ("kept_frac", K / S), live but dropped by it
    ("dropped_frac": a ray with more live slots than K) and evaluated by
    the density sample ("sampled_frac": valid_frac on the summed factor
    sample, which skips the dead slots, else kept_frac).  ``near_far`` may
    hold 0-d float32 tensors on the rays' device (a step captured in a
    CUDA graph, whose near plane moves with a schedule): they enter the
    same operations as the floats they hold, with the same bits."""
    n = centers.shape[0]
    S = rcfg.n_samples
    resolution = field.resolution()
    aabb = field.aabb.detach()
    aabb_size = aabb[1] - aabb[0]
    with tracing.span("render.sample"):
        res_t = field.resolution_tensor()
        near, far = (v if isinstance(v, torch.Tensor) else float(v)
                     for v in near_far)
        stratified = rcfg.is_train and rcfg.stratified

        viewdirs = dirs
        if rcfg.ndc:
            axes_w, z_vals, in_bbox = sample_ray_ndc(
                aabb, S, centers, dirs, near, far, stratified,
                rcfg.ndc_near_plane, rcfg.ndc_simulate_euclid_sample,
                rcfg.ndc_simulate_euclid_depth, jitter=ray_jitter,
                generator=generator)
            rays_norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
            dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                               torch.zeros_like(z_vals[:, :1])],
                              -1) * rays_norm
            viewdirs = dirs / rays_norm
        else:
            step = step_size(aabb, res_t, cfg.step_ratio)
            axes_w, z_vals, in_bbox, (t_min, jitter) = sample_ray_axes(
                aabb, step, S, centers, dirs, near, far, stratified,
                jitter=ray_jitter, generator=generator)
            dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                               torch.zeros_like(z_vals[:, :1])], -1)
        if stats is not None:
            stats["inbbox_frac"] = in_bbox.float().mean()

        # ------------------------------------------------ alpha-mask gate
        K = rcfg.compact_k if (rcfg.compact_k is not None
                               and rcfg.compact_k < S) else None
        stride = rcfg.mask_stride if S % max(rcfg.mask_stride, 1) == 0 else 1
        valid = in_bbox
        group_alive = None      # [n, S // stride]: per-group selection below
        if alpha_mask is not None:
            probe = tuple(w.detach()[:, ::stride].reshape(-1) for w in axes_w)
            group_alive = sample_alpha(alpha_mask, probe).reshape(
                n, S // stride) > 0
            if K is None or stride == 1 or K % stride or rcfg.ndc:
                valid = valid & torch.repeat_interleave(group_alive, stride,
                                                        dim=1)
                group_alive = None
        elif K is not None and stride > 1 and K % stride == 0 and not rcfg.ndc:
            # no mask in use: compact groups on the in-bbox gate alone
            group_alive = torch.ones((n, S // stride), dtype=torch.bool,
                                     device=centers.device)

        # ------------------------------------------------ sample compaction
        if K is not None:
            if group_alive is not None:
                # the first K / stride live probe groups, then their samples
                g = stride
                gvalid = group_alive & in_bbox.reshape(n, S // g, g).any(-1)
                live_before = gvalid
                topg, gsel = _first_k(gvalid, K // g)
                idx = (topg[..., None] * g
                       + torch.arange(g, device=topg.device)).reshape(n, K)
                live = torch.repeat_interleave(gsel, g, dim=1)
            else:
                live_before = valid
                idx, live = _first_k(valid, K)
            if rcfg.ndc:
                # the points are not o + d * z under the simulate flags: the
                # kept slots' points ride a gather
                z_vals = torch.gather(z_vals.detach(), 1, idx)
                dists = torch.gather(dists.detach(), 1, idx)
                axes_w = tuple(torch.gather(w, 1, idx) for w in axes_w)
            else:
                z_vals = (t_min[:, None] + step * (idx.to(z_vals.dtype)
                                                   + jitter)).detach()
                dists = torch.where(idx == S - 1, torch.zeros_like(z_vals),
                                    step.expand(z_vals.shape))
                axes_w = tuple(centers[:, a, None] + dirs[:, a, None] * z_vals
                               for a in range(3))
            valid = live & _in_bbox(axes_w, aabb) if group_alive is not None \
                else live
            if stats is not None:
                if group_alive is not None:
                    # the live samples of live groups
                    live_before = torch.repeat_interleave(
                        live_before, stride, dim=1) & in_bbox
                stats["valid_frac"] = valid.float().sum() / (n * S)
                stats["kept_frac"] = torch.full((), K / S,
                                                device=centers.device)
                stats["dropped_frac"] = (live_before.float().sum()
                                         - valid.float().sum()) / (n * S)
            S = K
        elif stats is not None:
            stats["valid_frac"] = valid.float().mean()
            stats["kept_frac"] = torch.full((), 1.0, device=centers.device)
            stats["dropped_frac"] = torch.zeros((), device=centers.device)

    with tracing.span("render.density"):
        d_mats = c_mats = None
        if blur is not None:
            grid_scale = _mean3(res_t / aabb_size)
            dk = vm_lib.c2f_kernel(blur.mode, c2f_density, blur.kernel_size,
                                   grid_scale)
            ck = vm_lib.c2f_kernel(blur.mode, c2f_color, blur.kernel_size,
                                   grid_scale)
            d_mats = vm_lib.make_blur_mats(dk, resolution)
            c_mats = vm_lib.make_blur_mats(ck, resolution)

        # ------------------------------------------------ density
        coords = tuple(vm_lib.normalize_coord(w, aabb[:, a]).reshape(-1)
                       for a, w in enumerate(axes_w))
        if rcfg.stop_coord_grad:
            coords = tuple(c.detach() for c in coords)
        head = field.shading

        def head_inputs(axes, m):
            """The head's points and view directions [n * m, 3], detached as
            the config asks."""
            pts = torch.stack(axes, dim=-1).reshape(-1, 3)
            vd = viewdirs[:, None, :].expand(n, m, 3).reshape(-1, 3)
            return (pts.detach() if rcfg.detach_xyz else pts,
                    vd.detach() if rcfg.detach_viewdirs else vd)

        predict = rcfg.mlp_predict_density
        route = density_route(rcfg, cfg, d_mats is not None)
        app_feat = rgb = None
        if route == "grid":
            with tracing.span("render.density.grid"):
                sigma_feature = vm_lib.sample_density_grid(
                    field, cfg, coords, blur_mats=d_mats,
                    row_dtype=rcfg.densify_dtype)
        elif route == "head":
            # the head gives the density feature (the reference's
            # batBase.py:106-109)
            rgb, sigma_feature = head(
                *head_inputs(axes_w, S), vm_lib.compute_app_feature(
                    field, cfg, coords, blur_mats=c_mats),
                view_pe_progress, fea_pe_progress)
        elif route == "fused":
            sigma_feature, app_feat = vm_lib.compute_fused_features(
                field, cfg, coords, d_mats=d_mats, c_mats=c_mats)
        else:
            with tracing.span("render.density.factored"):
                sigma_feature = vm_lib.compute_density_feature(
                    field, cfg, coords, blur_mats=d_mats,
                    live=valid.reshape(-1))
        if stats is not None:
            # the slots the density sample evaluated: the live ones alone
            # on the summed factor sample, every kept slot elsewhere
            skips = route == "factored" and \
                vm_lib.density_sample_skips_dead(cfg, d_mats is not None)
            stats["sampled_frac"] = stats["valid_frac" if skips
                                          else "kept_frac"]
        sigma_feature = sigma_feature.reshape(n, S)
        # a component-wise activated feature is the density already
        sigma = (sigma_feature if cfg.component_wise_feature2density
                 else vm_lib.feature2density(cfg, sigma_feature))
        sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
        alpha = 1.0 - torch.exp(-sigma * dists * cfg.distance_scale)
        thres = cfg.raymarch_weight_thres

    with tracing.span("render.appearance"):
        # ------------------------------------------------ appearance
        if rcfg.app_k is not None and not predict:
            K2 = min(rcfg.app_k, S)
            _, depth_map, acc_map, weight = composite(
                alpha, torch.zeros((n, S, 3), dtype=alpha.dtype,
                                   device=alpha.device), z_vals, thres)
            gate = (weight > thres) & valid
            score = torch.where(gate, weight,
                                torch.zeros_like(weight)).detach()
            sel = torch.topk(score, K2, dim=-1).indices.sort(dim=-1).values
            if stats is not None and field.comp is not None:
                # every comp rank reads the same reduced weights, so every
                # rank must keep the same samples
                sharding.verify_replicas(field.comp, {"app_k_selection": sel},
                                         "the two-stage selection",
                                         axis="comp")
            w_sel = torch.gather(weight, 1, sel)
            gate_sel = torch.gather(gate.to(weight.dtype), 1, sel)
            if rcfg.ndc:
                axes_sel = tuple(torch.gather(w, 1, sel) for w in axes_w)
            else:
                z_sel = torch.gather(z_vals.detach(), 1, sel)
                axes_sel = tuple(centers[:, a, None] + dirs[:, a, None] * z_sel
                                 for a in range(3))
            coords_sel = tuple(
                vm_lib.normalize_coord(w, aabb[:, a]).reshape(-1)
                for a, w in enumerate(axes_sel))
            if rcfg.stop_coord_grad:
                coords_sel = tuple(c.detach() for c in coords_sel)
            app_sel = vm_lib.compute_app_feature(field, cfg, coords_sel,
                                                 blur_mats=c_mats)
            rgb_sel = head(*head_inputs(axes_sel, K2), app_sel,
                           view_pe_progress, fea_pe_progress)
            rgb_sel = rgb_sel.reshape(n, K2, 3) * gate_sel[..., None]
            rgb_map = torch.sum(w_sel[..., None] * rgb_sel, dim=-2)
        elif predict:
            # the colour is gated by the sample's validity, not by its weight:
            # K1 composites colours pre-multiplied by ``valid`` ungated
            rgb = rgb.reshape(n, S, 3) * valid[..., None]
            rgb_map, depth_map, acc_map, _ = composite(alpha, rgb, z_vals)
        else:
            if app_feat is None:
                app_feat = vm_lib.compute_app_feature(field, cfg, coords,
                                                      blur_mats=c_mats)
            rgb = head(*head_inputs(axes_w, S), app_feat, view_pe_progress,
                       fea_pe_progress).reshape(n, S, 3)
            rgb_map, depth_map, acc_map, _ = composite(alpha, rgb, z_vals,
                                                       thres)

        if rcfg.white_bg:
            rgb_map = rgb_map + (1.0 - acc_map[..., None])
        elif rcfg.is_train:
            if bg_coin is None:
                bg_coin = torch.rand((), generator=generator,
                                     device=centers.device) < 0.5
            rgb_map = rgb_map + torch.as_tensor(
                bg_coin, dtype=rgb_map.dtype, device=rgb_map.device) * (
                    1.0 - acc_map[..., None])
        rgb_map = torch.clamp(rgb_map, 0.0, 1.0)

        depth_map = depth_map + (1.0 - acc_map) * dirs[..., -1]
        if rcfg.ndc_simulate_euclid_depth:
            depth_map = torch.clamp(depth_map, 0.0, 10.0)
        else:
            depth_map = depth_map - near + 0.05

    return rgb_map, depth_map.detach(), acc_map
