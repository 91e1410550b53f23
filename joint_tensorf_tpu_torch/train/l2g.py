"""L2G-BAT: local-to-global joint pose and TensoRF training step
(counterpart of joint_tensorf_tpu/train/l2g.py).

A small MLP predicts a per-ray se(3) warp from (the camera-plane pixel
coordinates, a per-view embedding); the rays are rendered through those
per-ray poses composed onto the view's base pose; one global SE(3) per
view is re-fit each step by rigid registration (batched Kabsch,
geometry/align.py) of the warped ray points against the camera-frame
points, and feeds both the table of optimised poses and a
global-alignment MSE loss.  With ``error_map_size`` > 0 the rays come from
the per-view error map: 1/3 importance and 2/3 uniform weighting, drawn
without replacement by a Gumbel top-k over the coarse cells, each cell
jittered to a pixel; the map is updated as 0.1 * old + 0.9 * new at the
drawn cells.

The warp embedding and MLP ride the pose optimiser (b2 = 0.999, the
pose-gradient accumulation and its cadence); the field rides the scene
optimiser.  The random draws (the Gumbel and cell-jitter uniforms, the
stratified jitter, the background coin) are taken pre-drawn or from a
torch.Generator: JAX's threefry draws cannot be replayed by torch, so the
parity tests pass JAX's own.

Under a mesh (train/step.py's docstring) every rank draws the error-map
rays of the whole step and renders its block of each view's rays.  The
registration needs each view's whole set of correspondences: every rank
warps every ray of the step (the warp MLP is small beside the render), so
the registration's input is the unsharded one bit for bit, on every rank,
and the ranks of rays index 0 add the registration loss (the render loss
reaches the warp through each rank's own block; under the comp layout
the warp's gradient is whole on every comp rank, as the pose table's
is).  The error map needs every ray's error:
the errors are gathered over the rays axis (one gather a step), and the
registered poses and the error map are updated alike on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from ..geometry import lie, poses as pose_ops
from ..geometry.align import rigid_points_registration
from ..geometry.ndc import convert_ndc
from ..geometry.rays import camera_grid_3d, pixel_grid
from ..models import vm as vm_lib
from ..parallel import sharding
from ..render.renderer import render_rays
from ..utils import tracing
from . import losses
from .optim import AdamState, adam_init, adam_update, field_lr_tree, masked_update
from .step import (StepConfig, StepScalars, add_regularizers, predraw,
                   rank_terms, reduce_step, render_loss_share)


@dataclasses.dataclass(frozen=True)
class L2GConfig:
    embedding_dim: int = 32
    layers_warp: tuple = (64, 64, 6)
    skip_warp: tuple = ()
    error_map_size: int = 0           # 0: the trainer's ray indices
    global_alignment_weight: float = 1.0
    error_map_ema: float = 0.9        # the new sample's weight


class WarpMLP(nn.Module):
    """The local warp: [2 + E] -> per-ray se(3) [6], ReLU between layers,
    the input concatenated again before each layer in ``skip_warp``.
    Layers are [fan_in, fan_out] as in JAX, drawn U(+-1/sqrt(fan_in)) from
    ``generator`` (zeros without one), the last layer zero so training
    starts at the base poses."""

    def __init__(self, cfg: L2GConfig, generator: Optional[torch.Generator]
                 = None, device=None):
        super().__init__()
        self.skip = tuple(int(i) for i in cfg.skip_warp)
        in_dim = 2 + cfg.embedding_dim
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        k_in = in_dim
        n = len(cfg.layers_warp)
        for li, k_out in enumerate(cfg.layers_warp):
            if li in self.skip:
                k_in += in_dim
            scale = 1.0 / math.sqrt(k_in)
            w = torch.zeros((k_in, k_out), device=device)
            b = torch.zeros((k_out,), device=device)
            if generator is not None and li != n - 1:
                w = (torch.rand((k_in, k_out), generator=generator,
                                device=device) * 2 - 1) * scale
                b = (torch.rand((k_out,), generator=generator,
                                device=device) * 2 - 1) * scale
            self.w.append(nn.Parameter(w))
            self.b.append(nn.Parameter(b))
            k_in = k_out

    def forward(self, uvf):
        feat = uvf
        n = len(self.w)
        for li in range(n):
            if li in self.skip:
                feat = torch.cat([feat, uvf], dim=-1)
            feat = feat @ self.w[li] + self.b[li]
            if li != n - 1:
                feat = torch.relu(feat)
        return feat


@dataclasses.dataclass
class L2GState:
    field: vm_lib.VMField
    warp_embedding: Any               # [V, E] leaf tensor
    warp_mlp: WarpMLP
    scene_opt: AdamState
    pose_opt: AdamState               # over pose_params
    pose_grad_accum: dict             # pose_params' keys
    optimised_poses: Any              # [V, 3, 4] world->cam, registered
    error_map: Any                    # [V, ems * ems] (or [V, 0])


def pose_params(state: L2GState) -> dict:
    """The parameters of the pose optimiser: {"warp_embedding",
    "warp_mlp.w.i", "warp_mlp.b.i"}."""
    out = {"warp_embedding": state.warp_embedding}
    for name, p in state.warp_mlp.named_parameters():
        out[f"warp_mlp.{name}"] = p
    return out


def init_l2g_state(field: vm_lib.VMField, l2g_cfg: L2GConfig, n_views: int,
                   pose_init, generator: Optional[torch.Generator] = None,
                   device=None) -> L2GState:
    """The embedding N(0, 1e-4^2) and the warp MLP from ``generator``
    (zeros without one); ``pose_init`` [V, 3, 4] starts the table of
    optimised poses; the error map starts at ones."""
    emb = torch.zeros((n_views, l2g_cfg.embedding_dim), device=device)
    if generator is not None:
        emb = torch.randn((n_views, l2g_cfg.embedding_dim),
                          generator=generator, device=device) * 1e-4
    state = L2GState(
        field=field, warp_embedding=emb.requires_grad_(True),
        warp_mlp=WarpMLP(l2g_cfg, generator, device),
        scene_opt=adam_init(dict(field.named_parameters())),
        pose_opt=None, pose_grad_accum=None,
        optimised_poses=torch.as_tensor(pose_init, device=device).clone(),
        error_map=torch.ones((n_views, l2g_cfg.error_map_size ** 2),
                             device=device))
    params = pose_params(state)
    state.pose_opt = adam_init(params)
    state.pose_grad_accum = {k: torch.zeros_like(p) for k, p in
                             params.items()}
    return state


def draw_error_map_uniforms(n_views: int, ems: int, n_rays: int,
                            generator: Optional[torch.Generator], device):
    """The Gumbel uniforms [B, ems^2] in [1e-10, 1) and the cell jitter
    [2, B, R] of one error-map draw."""
    u = torch.rand((n_views, ems * ems), generator=generator, device=device)
    gumbel_u = torch.clamp(1e-10 + (1.0 - 1e-10) * u, min=1e-10)
    jitter_u = torch.rand((2, n_views, n_rays), generator=generator,
                          device=device)
    return gumbel_u, jitter_u


def sample_error_map_rays(error_map, H: int, W: int, ems: int, n_rays: int,
                          gumbel_u, jitter_u):
    """Importance ray sampling from the per-view error map [B, ems^2]:
    weights e + 2 mean(e), without replacement by a Gumbel top-k
    (``gumbel_u`` [B, ems^2]), each coarse cell jittered to a pixel by
    ``jitter_u`` [2, B, R].  Returns (ray_idx [B, R], coarse [B, R])."""
    w = error_map + 2.0 * error_map.mean(dim=-1, keepdim=True)
    gumbel = -torch.log(-torch.log(gumbel_u))
    coarse = torch.topk(torch.log(w) + gumbel, n_rays, dim=-1).indices
    cx = coarse // ems
    cy = coarse % ems
    sx, sy = H / ems, W / ems
    ix = torch.clamp(((cx + jitter_u[0]) * sx).to(torch.int32), 0, H - 1)
    iy = torch.clamp(((cy + jitter_u[1]) * sy).to(torch.int32), 0, W - 1)
    return (ix * W + iy).to(torch.int64), coarse


def local_pose_and_rays(emb, warp_mlp: WarpMLP, base_pose, view_sel,
                        intr_inv, ray_idx, H: int, W: int):
    """Per-ray local poses and the rays through them.  base_pose [B,3,4];
    ray_idx [B,R] (per view) or [R] (shared); intr_inv [B,3,3].  Returns
    (centers, dirs, cam_grid, grid_world [B,R,3], local_se3 [B,R,6])."""
    B = base_pose.shape[0]
    if ray_idx.dim() == 1:
        cam_grid = camera_grid_3d(H, W, intr_inv, ray_idx=ray_idx)
    else:
        grid = pixel_grid(H, W, dtype=intr_inv.dtype, device=intr_inv.device)
        g = grid[ray_idx.reshape(-1)].reshape(B, ray_idx.shape[1], 2)
        g_h = torch.cat([g, torch.ones_like(g[..., :1])], dim=-1)
        cam_grid = (g_h @ intr_inv.transpose(-1, -2)).detach()
    R_ = cam_grid.shape[1]
    e = emb[view_sel][:, None, :]
    uvf = torch.cat([cam_grid[..., :2], e.expand(B, R_, e.shape[-1])], -1)
    local_se3 = warp_mlp(uvf)                                   # [B,R,6]
    local = pose_ops.compose_pair(lie.se3_to_SE3(local_se3),
                                  base_pose[:, None])           # [B,R,3,4]
    grid_world = pose_ops.cam2world(cam_grid[..., None, :], local)[..., 0, :]
    centers = pose_ops.cam2world(torch.zeros_like(cam_grid[..., None, :]),
                                 local)[..., 0, :]
    return centers, grid_world - centers, cam_grid, grid_world, local_se3


@tracing.spanned("step")
def l2g_train_step(state: L2GState, cfg: StepConfig, l2g_cfg: L2GConfig,
                   vm_cfg: vm_lib.VMConfig, pose_base, intr, intr_inv,
                   images, edge_masks, view_sel, ray_idx, s: StepScalars,
                   generator: Optional[torch.Generator] = None, jitter=None,
                   bg_coin=None, error_draws=None, alpha_mask=None,
                   stats: bool = False, mesh=None):
    """One L2G step, updating ``state`` in place; the call contract of
    step.train_step with ``error_draws`` = (gumbel_u, jitter_u) for the
    error-map draw (else drawn from ``generator``).  With an error map the
    given ray_idx is ignored and per-view indices are drawn.  Returns
    (metrics {loss, mse, psnr, global_alignment}, grads).  Under ``mesh``
    (module docstring) the draws given are the whole step's."""
    ems = l2g_cfg.error_map_size
    coarse = None
    field = state.field
    rcfg = cfg.render_config()
    render_stats = {} if stats else None
    with tracing.span("step.rays"):
        if ems > 0:
            if error_draws is None:
                error_draws = draw_error_map_uniforms(
                    len(view_sel), ems, cfg.rays_per_view, generator,
                    images.device)
            ray_idx, coarse = sample_error_map_rays(
                state.error_map[view_sel], cfg.H, cfg.W, ems,
                cfg.rays_per_view, *error_draws)
        if mesh is not None:
            n_views, n_rays = len(view_sel), ray_idx.shape[-1]
            jitter, bg_coin = predraw(cfg, n_views * n_rays, generator,
                                      images.device, jitter, bg_coin)
            if jitter is not None:
                jitter = sharding.shard_rays(mesh, jitter, n_views, n_rays)
        centers, dirs, cam_grid, grid_world, _ = local_pose_and_rays(
            state.warp_embedding, state.warp_mlp, pose_base[view_sel],
            view_sel, intr_inv[view_sel], ray_idx, cfg.H, cfg.W)
        world_centers = centers
        if mesh is not None:
            # every ray warped (the registration's points); this rank
            # renders its block of them
            blk = sharding.ray_block(mesh, n_rays)
            centers, dirs, ray_idx = centers[:, blk], dirs[:, blk], \
                ray_idx[..., blk]
        if cfg.ndc:
            centers, dirs = convert_ndc(centers, dirs, intr[view_sel],
                                        near=cfg.ndc_near_plane)
    B, R = centers.shape[:2]
    rgb, _, _ = render_rays(
        field, vm_cfg, rcfg, centers.reshape(-1, 3), dirs.reshape(-1, 3),
        s.near_far, blur=cfg.blur, c2f_density=s.c2f_density,
        c2f_color=s.c2f_color, view_pe_progress=s.view_pe_progress,
        fea_pe_progress=s.fea_pe_progress, ray_jitter=jitter,
        generator=generator, alpha_mask=alpha_mask, stats=render_stats,
        bg_coin=bg_coin)
    with tracing.span("step.loss"):
        rgb = rgb.reshape(B, R, 3)
        if ray_idx.dim() == 1:
            target = images[:, ray_idx][view_sel]
            mask = edge_masks[:, ray_idx][view_sel]
        else:
            target = torch.gather(images[view_sel], 1,
                                  ray_idx[..., None].expand(B, R, 3))
            mask = torch.gather(edge_masks[view_sel], 1, ray_idx)

        if mesh is None:
            loss = losses.edge_weighted_render_loss(
                rgb, target, mask, s.edge_factor, s.non_edge_factor,
                s.use_edge)
            plain_mse = losses.mse(rgb, target)
        else:
            loss, sq_sum, counts = render_loss_share(mesh, rgb, target,
                                                     mask, s)
        per_ray_err = torch.mean((rgb - target) ** 2,
                                 dim=-1).detach()                # [B,R]
        if mesh is not None and ems > 0:
            per_ray_err = sharding.gather_rays(mesh, per_ray_err)

        # global alignment: one SE(3) a view from the warped ray points
        source = torch.cat([cam_grid, torch.zeros_like(cam_grid)], dim=1)
        target_pts = torch.cat([grid_world, world_centers], dim=1)
        R_g, t_g = rigid_points_registration(target_pts, source)
        svd_poses = pose_ops.make(R_g, t_g)                      # [B,3,4]
        ga_loss = losses.mse(target_pts,
                             pose_ops.cam2world(source, svd_poses))
        # the registration term and the replicated terms once a rays group
        if mesh is None:
            loss = add_regularizers(
                loss + l2g_cfg.global_alignment_weight * ga_loss, field, s)
        else:
            loss, report, partial = rank_terms(
                mesh, field, s, loss,
                l2g_cfg.global_alignment_weight * ga_loss)

    params = dict(field.named_parameters())
    names = list(params)
    pparams = pose_params(state)
    pnames = list(pparams)
    with tracing.span("step.backward"):
        g = torch.autograd.grad(loss, [params[k] for k in names]
                                + [pparams[k] for k in pnames])
    grads = dict(zip(names + pnames, g))
    if mesh is not None:
        with tracing.span("step.reduce"):
            grads, metrics = reduce_step(mesh, grads, report, sq_sum,
                                         counts[2], render_stats, partial)

    with torch.no_grad():
        with tracing.span("step.adam"):
            lrs = field_lr_tree(field, s.lr_index, s.lr_basis)
            new_params, state.scene_opt = adam_update(
                {k: grads[k] for k in names}, state.scene_opt, params, lrs,
                b2=cfg.scene_b2)
            for k in names:
                params[k].copy_(new_params[k])

            do_step = s.pose_do_step > 0
            accum = {k: state.pose_grad_accum[k] + grads[k] for k in pnames}
            old = {k: pparams[k] for k in pnames}
            new_pose, new_opt = adam_update(accum, state.pose_opt, old,
                                            s.lr_pose, b2=cfg.pose_b2)
            new_pose, state.pose_opt = masked_update(
                do_step, new_pose, new_opt, old, state.pose_opt)
            for k in pnames:
                pparams[k].copy_(new_pose[k])
            state.pose_grad_accum = ({k: torch.zeros_like(a)
                                      for k, a in accum.items()}
                                     if do_step else accum)

        optimised = state.optimised_poses.clone()
        optimised[view_sel] = svd_poses.detach()
        state.optimised_poses = optimised
        if ems > 0:
            rows = state.error_map[view_sel]
            old_err = torch.gather(rows, 1, coarse)
            ema = ((1.0 - l2g_cfg.error_map_ema) * old_err
                   + l2g_cfg.error_map_ema * per_ray_err)
            error_map = state.error_map.clone()
            error_map[view_sel] = rows.scatter(1, coarse, ema)
            state.error_map = error_map

    if mesh is None:
        metrics = {"loss": loss.detach(), "mse": plain_mse.detach(),
                   "psnr": losses.psnr_from_mse(plain_mse.detach())}
        if stats:
            metrics.update(render_stats)
    metrics["global_alignment"] = ga_loss.detach()
    if stats:
        metrics["blur"] = float(cfg.blur is not None)
    return metrics, grads


def l2g_depth_range(optimised_poses, depth_range):
    """The scene depth range rescaled by the diameter of the registered
    cameras: (near, far) as floats.  Reads the poses on the host (one
    device-to-host copy), as JAX does every step."""
    pos = pose_ops.invert(optimised_poses.detach()).cpu().numpy()[..., 3]
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1).max()
    dmin, dmax = depth_range
    return (dmin / (dmax + dmin) * d, dmax / (dmax + dmin) * d)
