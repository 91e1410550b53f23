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

Under a mesh (parallel/, the ``rays`` layout) every rank holds the whole
state, draws the step's whole jitter and background coin from the same
generator state (predraw: the unsharded renderer's draws, in its order)
and renders its block of every view's rays.  Its loss is its share: the
render loss as its nansums over the global non-NaN counts (one small
all-reduce before the backward), the replicated terms (density L1, the
factors' TV) on the ranks of rays index 0 only, and the depth TV of the
gathered depth on every rank (its gather's backward takes each rank's
block; the renderer stops depth's gradient, as JAX's does, so the term
moves only the loss).  So the ranks' gradients sum to the unsharded
gradient.  They are summed in one all-reduce of one flat bucket over the
rays group, with the loss and the plain MSE's numerator beside them, and
every rank runs the same Adam update on the same bytes, so the replicas
stay equal.  PSNR is recomputed from the reduced MSE, as JAX's sharded
step does.

Under the comp layout (a ``comp`` axis of size C; the field holds its
rank's component blocks, models/vm.py) the field's features are summed
over the comp group inside the forward and the sample coordinates' parts
inside the backward (Megatron's conjugate pair, parallel/sharding.py), so
every rank of a comp group computes the same render loss, head and pose
gradients.  The gradients then keep four invariants: a factor block's is
this rank's, summed over the rays group only; the basis rows of this
rank's components get theirs here alone, so the basis gradient is summed
over the comp group first (one small all-reduce, with the regularisers'
shares beside it: the regularisers are sums over components, each rank's
share of them a local sum over the global element count); the head's and
the pose table's are whole on every comp rank and summed over the rays
group only.  A step makes per comp rank one forward all-reduce per
feature call, one backward all-reduce per call whose coordinates carry a
gradient, the comp-group bucket and the rays-group bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..geometry import lie, poses as pose_ops
from ..geometry.ndc import convert_ndc
from ..geometry.rays import get_center_and_ray
from ..models import vm as vm_lib
from ..parallel import sharding
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


def predraw(cfg: StepConfig, n_rays: int, generator, device, jitter=None,
           bg_coin=None):
    """The step's stratified jitter ([n, 1], [n, S] under NDC) and
    background coin as the renderer draws them when not given: the jitter
    first, then the coin, each only where the step uses it."""
    if cfg.stratified and jitter is None:
        jitter = torch.rand((n_rays, cfg.n_samples if cfg.ndc else 1),
                            generator=generator, device=device)
    if not cfg.white_bg and bg_coin is None:
        bg_coin = torch.rand((), generator=generator, device=device) < 0.5
    return jitter, bg_coin


def render_loss_share(mesh, rgb, target, mask, s: StepScalars):
    """Under a mesh: (this rank's share of the edge-weighted render loss,
    the plain squared error's nansum, the global non-NaN counts [3])."""
    sums, counts = losses.edge_weighted_sum_count(rgb, target, mask)
    counts = sharding.reduce_counts(mesh, counts)
    share = losses.edge_weighted_from_sums(sums, counts, s.edge_factor,
                                           s.non_edge_factor, s.use_edge)
    return share, sums[2], counts


def add_regularizers(loss, field, s: StepScalars):
    """``loss`` plus density L1 and the factors' TV with their weights,
    float32 like JAX's product with a traced weight (bf16 factors make
    density_L1 bf16)."""
    loss = loss + s.l1_weight * vm_lib.density_L1(field).float()
    if s.tv_density_weight:
        loss = loss + s.tv_density_weight * vm_lib.tv_loss_density(
            field).float()
    if s.tv_color_weight:
        loss = loss + s.tv_color_weight * vm_lib.tv_loss_app(field).float()
    return loss


def regularizers(field, s: StepScalars):
    """Density L1 and the factors' TV with their weights, as a float32
    0-d tensor (this rank's share of them under the comp layout)."""
    return add_regularizers(torch.zeros((), device=field.aabb.device),
                            field, s)


def rank_terms(mesh, field, s: StepScalars, loss, extra=None):
    """Under a mesh, ``loss`` (this rank's render share) plus, on the
    ranks of rays index 0, ``extra`` (a term computed identically on every
    rank) and the regularisers.  Returns (the loss to differentiate, its
    reported value, the comp group's partial): without the comp layout the
    report holds everything and the partial is None; with it the
    regularisers' share is the partial (zero off rays index 0), summed
    over the comp group by reduce_step."""
    report, partial = loss, None
    if mesh.rays_index == 0:
        if extra is not None:
            loss = loss + extra
        reg = regularizers(field, s)
        report = loss if field.comp is not None else loss + reg
        partial = reg if field.comp is not None else None
        loss = loss + reg
    elif field.comp is not None:
        partial = torch.zeros((), device=loss.device)
    return loss, report, partial


def reduce_step(mesh, grads: dict, loss_report, sq_sum, count, stats=None,
                partial=None):
    """The reductions of a sharded step.  Under the comp layout
    (``partial`` given) first the basis gradient and ``partial`` over the
    comp group; then the gradients, the loss, the plain MSE's numerator
    and (``stats``) the render fractions / R, in one bucket over the rays
    group.  Returns (grads, metrics) with PSNR from the reduced MSE."""
    if partial is not None:
        basis, partial = sharding.reduce_bucket(
            mesh, [grads["basis"], partial.detach().float()], axis="comp",
            purpose="comp_grads")
        grads = dict(grads, basis=basis)
        loss_report = loss_report.detach().float() + partial
    keys = list(grads)
    skeys = sorted(stats) if stats else []
    extra = [loss_report.detach().float(), sq_sum.detach().float()] + [
        torch.as_tensor(stats[k], dtype=torch.float32) / mesh.rays
        for k in skeys]
    red = sharding.reduce_bucket(mesh, [grads[k] for k in keys] + extra)
    n = len(keys)
    mse = red[n + 1] / count
    metrics = {"loss": red[n], "mse": mse, "psnr": losses.psnr_from_mse(mse)}
    metrics.update(zip(skeys, red[n + 2:]))
    return dict(zip(keys, red[:n])), metrics


def train_step(state: TrainState, cfg: StepConfig, vm_cfg: vm_lib.VMConfig,
               pose_base, intr_inv, images, edge_masks, view_sel, ray_idx,
               s: StepScalars, generator: Optional[torch.Generator] = None,
               jitter=None, alpha_mask=None, stats: bool = False, intr=None,
               bg_coin=None, mesh=None):
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

    ``mesh`` (parallel/mesh.Mesh): render this rank's block of each view's
    rays and return the reduced metrics and gradients (module docstring);
    ``jitter`` and ``bg_coin`` are then the whole step's.
    """
    field = state.field
    rcfg = cfg.render_config()
    render_stats = {} if stats else None
    if mesh is not None:
        n_views, n_rays = view_sel.shape[0], ray_idx.shape[-1]
        jitter, bg_coin = predraw(cfg, n_views * n_rays, generator,
                                  images.device, jitter, bg_coin)
        if jitter is not None:
            jitter = sharding.shard_rays(mesh, jitter, n_views, n_rays)
        ray_idx = ray_idx[sharding.ray_block(mesh, n_rays)]
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

    if mesh is None:
        loss = losses.edge_weighted_render_loss(
            rgb, target, mask, s.edge_factor, s.non_edge_factor, s.use_edge)
        plain_mse = losses.mse(rgb, target)
        loss = add_regularizers(loss, field, s)
        if cfg.grid_hw is not None:
            gh, gw = cfg.grid_hw
            loss = loss + s.tv_depth_weight * losses.depth_tv_loss(
                depth.reshape(B, R), gh, gw)
    else:
        loss, sq_sum, counts = render_loss_share(mesh, rgb, target, mask, s)
        loss, report, partial = rank_terms(mesh, field, s, loss)
        # the term enters every rank's loss (its gather's backward takes
        # this rank's block) and the reported loss once a rays group;
        # without weight no gather is made
        if cfg.grid_hw is not None and s.tv_depth_weight:
            gh, gw = cfg.grid_hw
            tv = s.tv_depth_weight * losses.depth_tv_loss(
                sharding.gather_rays(mesh, depth.reshape(B, R)), gh, gw)
            loss = loss + tv
            report = report + tv if mesh.rays_index == 0 else report

    params = dict(field.named_parameters())
    names = list(params)
    wrt = [params[k] for k in names]
    if cfg.pose_opt:
        wrt.append(state.se3_refine)
    grads = dict(zip(names + ["se3_refine"], torch.autograd.grad(loss, wrt)))
    if mesh is not None:
        grads, metrics = reduce_step(mesh, grads, report, sq_sum, counts[2],
                                     render_stats, partial)
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

    if mesh is None:
        metrics = {"loss": loss.detach(), "mse": plain_mse.detach(),
                   "psnr": losses.psnr_from_mse(plain_mse.detach())}
        if stats:
            metrics.update(render_stats)
    if stats:
        metrics["blur"] = float(cfg.blur is not None)
    return metrics, grads
