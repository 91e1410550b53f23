"""One training step: geometry -> renderer -> VM field -> kernels -> loss
-> Adam (counterpart of joint_tensorf_tpu/train/step.py:159-304).

Under ``ndc`` the rays are converted to NDC (geometry/ndc.py) before the
renderer; ``pin_first_pose`` zeroes view 0's pose gradient (the gauge
anchor of forward-facing captures); the TV terms of the factor planes
join the loss with their weights.

With pose optimisation (BAT), one backward pass over (factor grids, basis,
shading MLP, se(3) pose table) gives the joint gradient: pose gradients
reach the se3 table through ray generation -> sample positions -> bilinear
coordinate derivatives.  The scene update happens every step (b2 = 0.99);
the pose update (b2 = 0.999) applies the accumulated pose gradient on the
accumulation cadence.  Without it (TensoRF) the rays come from the base
poses, the sample coordinates are detached, and the pose table, its
moments and its accumulator stay as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..geometry import lie, poses as pose_ops
from ..geometry.ndc import convert_ndc
from ..geometry.rays import get_center_and_ray
from ..models import vm as vm_lib
from ..render.renderer import BlurSpec, RenderConfig, render_rays
from . import losses
from .optim import AdamState, adam_init, adam_update, field_lr_tree, masked_update


@dataclasses.dataclass
class StepScalars:
    """Per-iteration host scalars."""
    lr_index: float = 0.0
    lr_basis: float = 0.0
    lr_pose: float = 0.0
    c2f_density: float = 0.0
    c2f_color: float = 0.0
    near_far: tuple = (2.0, 6.0)
    l1_weight: float = 0.0
    use_edge: float = 0.0
    edge_factor: float = 1.0
    non_edge_factor: float = 1.0
    view_pe_progress: float = 1.0
    fea_pe_progress: float = 1.0
    pose_do_step: float = 1.0
    tv_depth_weight: float = 0.0
    tv_density_weight: float = 0.0
    tv_color_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The step's static choices.  ``pose_opt``: the se(3) pose table is
    optimised (BAT; TensoRF runs with it off, and the JAX StepConfig's
    default is off).  The renderer options (alpha-mask gate, compaction,
    dense grid with its row dtype, two-stage appearance) are the JAX
    StepConfig's (joint_tensorf_tpu/train/step.py:99-138); its remat_*
    flags are XLA memory choices and its densify_impl picks between two
    TPU layouts of one sampler, so neither has a counterpart; its
    use_alpha_mask and mask_with_blur are the choice of the mask passed to
    train_step (Trainer._step_mask).  ``white_bg`` false: the random
    background coin in training; ``ndc``: NDC rays, with the near plane
    and the simulate flags of the JAX StepConfig; ``stratified``,
    ``detach_viewdirs``, ``detach_xyz`` and ``mlp_predict_density``: the
    renderer's (RenderConfig).  Without ``stratified`` no jitter is drawn
    (a given one is not read), as JAX pre-draws it only when
    stratified."""
    H: int
    W: int
    n_views: int
    rays_per_view: int
    n_samples: int
    pose_opt: bool = True
    blur: Optional[BlurSpec] = None
    grid_hw: Optional[tuple[int, int]] = None   # all_view_rand_grid TV-depth
    mask_stride: int = 4                        # alpha-mask probe stride
    compact_k: Optional[int] = None             # sample compaction budget
    densify_density: bool = False               # dense-grid density
    densify_dtype: str = "float32"              # dense-grid row reads
    app_k: Optional[int] = None                 # two-stage appearance top-K2
    pose_b2: float = 0.999
    scene_b2: float = 0.99
    white_bg: bool = True
    ndc: bool = False
    ndc_near_plane: float = 1.0
    ndc_simulate_euclid_sample: bool = False
    ndc_simulate_euclid_depth: bool = False
    pin_first_pose: bool = False
    stratified: bool = True
    detach_viewdirs: bool = True
    detach_xyz: bool = True
    mlp_predict_density: bool = False

    def render_config(self) -> RenderConfig:
        return RenderConfig(
            n_samples=self.n_samples, is_train=True,
            stratified=self.stratified,
            detach_viewdirs=self.detach_viewdirs, detach_xyz=self.detach_xyz,
            mlp_predict_density=self.mlp_predict_density,
            mask_stride=self.mask_stride, compact_k=self.compact_k,
            densify_density=self.densify_density,
            densify_dtype=self.densify_dtype, app_k=self.app_k,
            stop_coord_grad=not self.pose_opt, white_bg=self.white_bg,
            ndc=self.ndc, ndc_near_plane=self.ndc_near_plane,
            ndc_simulate_euclid_sample=self.ndc_simulate_euclid_sample,
            ndc_simulate_euclid_depth=self.ndc_simulate_euclid_depth)


@dataclasses.dataclass
class TrainState:
    field: vm_lib.VMField
    se3_refine: Any          # [n_views, 6] leaf tensor
    scene_opt: AdamState
    pose_opt: AdamState
    pose_grad_accum: Any     # [n_views, 6]


def init_train_state(field: vm_lib.VMField, n_views: int) -> TrainState:
    dev = field.aabb.device
    se3 = torch.zeros((n_views, 6), device=dev, requires_grad=True)
    return TrainState(
        field=field, se3_refine=se3,
        scene_opt=adam_init(dict(field.named_parameters())),
        pose_opt=adam_init({"se3_refine": se3}),
        pose_grad_accum=torch.zeros((n_views, 6), device=dev))


def rebuild_opt_state(state: TrainState) -> TrainState:
    """Fresh Adam moments for the field after a shape transition; the pose
    optimiser and the pose-gradient accumulator are kept
    (joint_tensorf_tpu/train/step.py:321-329)."""
    state.scene_opt = adam_init(dict(state.field.named_parameters()))
    return state


def compose_train_pose(se3_refine, pose_base, view_sel,
                       pose_opt: bool = True):
    """pose = refine o (GT o noise) for the selected views; the base poses
    alone without pose optimisation."""
    if not pose_opt:
        return pose_base[view_sel]
    refine = lie.se3_to_SE3(se3_refine[view_sel])
    return pose_ops.compose([refine, pose_base[view_sel]])


def train_step(state: TrainState, cfg: StepConfig, vm_cfg: vm_lib.VMConfig,
               pose_base, intr_inv, images, edge_masks, view_sel, ray_idx,
               s: StepScalars, generator: Optional[torch.Generator] = None,
               jitter=None, alpha_mask=None, stats: bool = False, intr=None,
               bg_coin=None):
    """One step, updating ``state`` in place (parameters are overwritten
    with their Adam update; the parity tests read them back).

    images [V, H*W, 3], edge_masks [V, H*W], view_sel [Vs], ray_idx [R];
    ``jitter`` [Vs*R, 1] (Euclidean) or [Vs*R, S] (NDC) pre-drawn
    stratified offsets and ``bg_coin`` the background coin (else drawn
    from ``generator``); ``alpha_mask``, when given, gates the samples;
    ``intr`` [V, 3, 3] (read under NDC).
    Returns (metrics {loss, mse, psnr} as 0-d tensors, grads {name: tensor}
    incl. "se3_refine", zeros without pose optimisation, as JAX's gradient
    of the unused table is); with ``stats`` the metrics also hold the fractions
    of sample slots in the box, live after the mask and kept by the
    compaction ("inbbox_frac", "valid_frac", "kept_frac"; render_rays) and
    whether the factors were blurred ("blur", 0 or 1).
    """
    field = state.field
    rcfg = cfg.render_config()
    render_stats = {} if stats else None
    pose = compose_train_pose(state.se3_refine, pose_base, view_sel,
                              cfg.pose_opt)
    centers, dirs = get_center_and_ray(cfg.H, cfg.W, pose, intr_inv[view_sel],
                                       ray_idx=ray_idx)
    if cfg.ndc:
        centers, dirs = convert_ndc(centers, dirs, intr[view_sel],
                                    near=cfg.ndc_near_plane)
    B, R = centers.shape[0], centers.shape[1]
    rgb, depth, _ = render_rays(
        field, vm_cfg, rcfg, centers.reshape(-1, 3), dirs.reshape(-1, 3),
        s.near_far, blur=cfg.blur, c2f_density=s.c2f_density,
        c2f_color=s.c2f_color, view_pe_progress=s.view_pe_progress,
        fea_pe_progress=s.fea_pe_progress, ray_jitter=jitter,
        generator=generator, alpha_mask=alpha_mask, stats=render_stats,
        bg_coin=bg_coin)
    rgb = rgb.reshape(B, R, 3)
    # the small ray subset first, then the views
    target = images[:, ray_idx][view_sel]                        # [B,R,3]
    mask = edge_masks[:, ray_idx][view_sel]                      # [B,R]

    loss = losses.edge_weighted_render_loss(
        rgb, target, mask, s.edge_factor, s.non_edge_factor, s.use_edge)
    plain_mse = losses.mse(rgb, target)
    # float32 like JAX's product with a traced weight (bf16 factors make
    # density_L1 bf16)
    loss = loss + s.l1_weight * vm_lib.density_L1(field).float()
    if s.tv_density_weight:
        loss = loss + s.tv_density_weight * vm_lib.tv_loss_density(
            field).float()
    if s.tv_color_weight:
        loss = loss + s.tv_color_weight * vm_lib.tv_loss_app(field).float()
    if cfg.grid_hw is not None:
        gh, gw = cfg.grid_hw
        loss = loss + s.tv_depth_weight * losses.depth_tv_loss(
            depth.reshape(B, R), gh, gw)

    params = dict(field.named_parameters())
    names = list(params)
    wrt = [params[k] for k in names]
    if cfg.pose_opt:
        wrt.append(state.se3_refine)
    grads = dict(zip(names + ["se3_refine"], torch.autograd.grad(loss, wrt)))
    if not cfg.pose_opt:
        grads["se3_refine"] = torch.zeros_like(state.se3_refine)

    with torch.no_grad():
        lrs = field_lr_tree(field, s.lr_index, s.lr_basis)
        new_params, state.scene_opt = adam_update(
            grads, state.scene_opt, params, lrs, b2=cfg.scene_b2)
        for k in names:
            params[k].copy_(new_params[k])

    # pose update on the accumulation cadence (pose_do_step)
    if cfg.pose_opt:
        with torch.no_grad():
            g_se3 = grads["se3_refine"]
            if cfg.pin_first_pose:
                g_se3 = g_se3.clone()
                g_se3[0] = 0.0
            accum = state.pose_grad_accum + g_se3
            do_step = s.pose_do_step > 0
            old = {"se3_refine": state.se3_refine}
            new_se3, new_opt = adam_update(
                {"se3_refine": accum}, state.pose_opt, old, s.lr_pose,
                b2=cfg.pose_b2)
            new_se3, state.pose_opt = masked_update(
                do_step, new_se3, new_opt, old, state.pose_opt)
            state.se3_refine.copy_(new_se3["se3_refine"])
            state.pose_grad_accum = (torch.zeros_like(accum) if do_step
                                     else accum)

    metrics = {"loss": loss.detach(), "mse": plain_mse.detach(),
               "psnr": losses.psnr_from_mse(plain_mse.detach())}
    if stats:
        metrics.update(render_stats, blur=float(cfg.blur is not None))
    return metrics, grads
