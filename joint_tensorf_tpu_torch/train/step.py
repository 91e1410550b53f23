"""One training step: geometry -> renderer -> VM field -> kernels -> loss
-> Adam (counterpart of joint_tensorf_tpu/train/step.py:159-304).

One backward pass over (factor grids, basis, shading MLP, se(3) pose table)
gives the joint gradient: pose gradients reach the se3 table through ray
generation -> sample positions -> bilinear coordinate derivatives.  The
scene update happens every step (b2 = 0.99); the pose update (b2 = 0.999)
applies the accumulated pose gradient on the accumulation cadence.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..geometry import lie, poses as pose_ops
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


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """BAT's step: the se(3) pose table is always optimised."""
    H: int
    W: int
    n_views: int
    rays_per_view: int
    n_samples: int
    blur: Optional[BlurSpec] = None
    grid_hw: Optional[tuple[int, int]] = None   # all_view_rand_grid TV-depth
    mask_stride: int = 4                        # alpha-mask probe stride
    pose_b2: float = 0.999
    scene_b2: float = 0.99


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


def compose_train_pose(se3_refine, pose_base, view_sel):
    """pose = refine o (GT o noise) for the selected views."""
    refine = lie.se3_to_SE3(se3_refine[view_sel])
    return pose_ops.compose([refine, pose_base[view_sel]])


def train_step(state: TrainState, cfg: StepConfig, vm_cfg: vm_lib.VMConfig,
               pose_base, intr_inv, images, edge_masks, view_sel, ray_idx,
               s: StepScalars, generator: Optional[torch.Generator] = None,
               jitter=None, alpha_mask=None, stats: bool = False):
    """One step, updating ``state`` in place (parameters are overwritten
    with their Adam update; the parity tests read them back).

    images [V, H*W, 3], edge_masks [V, H*W], view_sel [Vs], ray_idx [R];
    ``jitter`` [Vs*R, 1] pre-drawn stratified offsets (else drawn from
    ``generator``); ``alpha_mask`` gates samples while the blur is off.
    Returns (metrics {loss, mse, psnr} as 0-d tensors, grads {name: tensor}
    incl. "se3_refine"); with ``stats`` the metrics also hold the fractions
    of samples in the box and kept after the mask ("inbbox_frac",
    "valid_frac") and whether the factors were blurred ("blur", 0 or 1).
    """
    field = state.field
    rcfg = RenderConfig(n_samples=cfg.n_samples, is_train=True,
                        mask_stride=cfg.mask_stride)
    render_stats = {} if stats else None
    pose = compose_train_pose(state.se3_refine, pose_base, view_sel)
    centers, dirs = get_center_and_ray(cfg.H, cfg.W, pose, intr_inv[view_sel],
                                       ray_idx=ray_idx)
    B, R = centers.shape[0], centers.shape[1]
    rgb, depth, _ = render_rays(
        field, vm_cfg, rcfg, centers.reshape(-1, 3), dirs.reshape(-1, 3),
        s.near_far, blur=cfg.blur, c2f_density=s.c2f_density,
        c2f_color=s.c2f_color, view_pe_progress=s.view_pe_progress,
        fea_pe_progress=s.fea_pe_progress, ray_jitter=jitter,
        generator=generator, alpha_mask=alpha_mask, stats=render_stats)
    rgb = rgb.reshape(B, R, 3)
    # the small ray subset first, then the views
    target = images[:, ray_idx][view_sel]                        # [B,R,3]
    mask = edge_masks[:, ray_idx][view_sel]                      # [B,R]

    loss = losses.edge_weighted_render_loss(
        rgb, target, mask, s.edge_factor, s.non_edge_factor, s.use_edge)
    plain_mse = losses.mse(rgb, target)
    loss = loss + s.l1_weight * vm_lib.density_L1(field)
    if cfg.grid_hw is not None:
        gh, gw = cfg.grid_hw
        loss = loss + s.tv_depth_weight * losses.depth_tv_loss(
            depth.reshape(B, R), gh, gw)

    params = dict(field.named_parameters())
    names = list(params)
    g = torch.autograd.grad(loss, [params[k] for k in names]
                            + [state.se3_refine])
    grads = dict(zip(names + ["se3_refine"], g))

    with torch.no_grad():
        lrs = field_lr_tree(field, s.lr_index, s.lr_basis)
        new_params, state.scene_opt = adam_update(
            grads, state.scene_opt, params, lrs, b2=cfg.scene_b2)
        for k in names:
            params[k].copy_(new_params[k])

        # pose update on the accumulation cadence (pose_do_step)
        accum = state.pose_grad_accum + grads["se3_refine"]
        do_step = s.pose_do_step > 0
        old = {"se3_refine": state.se3_refine}
        new_se3, new_opt = adam_update(
            {"se3_refine": accum}, state.pose_opt, old, s.lr_pose,
            b2=cfg.pose_b2)
        new_se3, state.pose_opt = masked_update(
            do_step, new_se3, new_opt, old, state.pose_opt)
        state.se3_refine.copy_(new_se3["se3_refine"])
        state.pose_grad_accum = torch.zeros_like(accum) if do_step else accum

    metrics = {"loss": loss.detach(), "mse": plain_mse.detach(),
               "psnr": losses.psnr_from_mse(plain_mse.detach())}
    if stats:
        metrics.update(render_stats, blur=float(cfg.blur is not None))
    return metrics, grads
