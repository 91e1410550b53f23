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
from ..utils import tracing
from . import losses
from .optim import (AdamState, adam_init, adam_scales, adam_update,
                    adam_update_, field_lr_tree, frozen, masked_adam_update_)


@dataclasses.dataclass
class StepScalars:
    """Per-iteration host scalars (a step captured in a CUDA graph,
    train/graph_step.py, reads the ones that move within a step shape as
    0-d device tensors)."""
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


def _on(weight) -> bool:
    """A term's weight is on: a nonzero host float, or a device value (a
    captured step passes a weight that is 0 as the host 0.0)."""
    return isinstance(weight, torch.Tensor) or bool(weight)


def add_regularizers(loss, field, s: StepScalars):
    """``loss`` plus density L1 and the factors' TV with their weights,
    float32 like JAX's product with a traced weight (bf16 factors make
    density_L1 bf16)."""
    loss = loss + s.l1_weight * vm_lib.density_L1(field).float()
    if _on(s.tv_density_weight):
        loss = loss + s.tv_density_weight * vm_lib.tv_loss_density(
            field).float()
    if _on(s.tv_color_weight):
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


@tracing.spanned("step")
def train_step(state: TrainState, cfg: StepConfig, vm_cfg: vm_lib.VMConfig,
               pose_base, intr_inv, images, edge_masks, view_sel, ray_idx,
               s: StepScalars, generator: Optional[torch.Generator] = None,
               jitter=None, alpha_mask=None, stats: bool = False, intr=None,
               bg_coin=None, mesh=None):
    """One step, updating ``state`` in place (parameters, both Adams'
    moments and the pose-gradient accumulator are overwritten; the parity
    tests read them back).

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

    Without a mesh the step is unsharded_step, the function a CUDA graph
    captures (train/graph_step.py), with host scalars.  ``mesh``
    (parallel/mesh.Mesh): render this rank's block of each view's rays and
    return the reduced metrics and gradients (module docstring); ``jitter``
    and ``bg_coin`` are then the whole step's.
    """
    if mesh is None:
        metrics, grads = unsharded_step(
            state, cfg, vm_cfg, pose_base, intr_inv, images, edge_masks,
            view_sel, ray_idx, s, jitter=jitter, alpha_mask=alpha_mask,
            intr=intr, bg_coin=bg_coin, generator=generator, stats=stats)
    else:
        metrics, grads = _sharded_step(
            state, cfg, vm_cfg, pose_base, intr_inv, images, edge_masks,
            view_sel, ray_idx, s, generator, jitter, alpha_mask, stats,
            intr, bg_coin, mesh)
    advance_counts(state, cfg, s)
    if not cfg.pose_opt:
        grads["se3_refine"] = torch.zeros_like(state.se3_refine)
    if stats:
        metrics["blur"] = float(cfg.blur is not None)
    return metrics, grads


def _sharded_step(state: TrainState, cfg: StepConfig, vm_cfg, pose_base,
                  intr_inv, images, edge_masks, view_sel, ray_idx,
                  s: StepScalars, generator, jitter, alpha_mask, stats,
                  intr, bg_coin, mesh):
    """train_step under a mesh, its counts left to advance -> (metrics,
    grads)."""
    field = state.field
    render_stats = {} if stats else None
    with tracing.span("step.rays"):
        n_views, n_rays = view_sel.shape[0], ray_idx.shape[-1]
        jitter, bg_coin = predraw(cfg, n_views * n_rays, generator,
                                  images.device, jitter, bg_coin)
        if jitter is not None:
            jitter = sharding.shard_rays(mesh, jitter, n_views, n_rays)
        ray_idx = ray_idx[sharding.ray_block(mesh, n_rays)]
        centers, dirs = _rays(state, cfg, pose_base, intr_inv, intr,
                              view_sel, ray_idx)
    rgb, depth = _render(field, cfg, vm_cfg, centers, dirs, s, jitter,
                         generator, alpha_mask, render_stats, bg_coin)
    with tracing.span("step.loss"):
        target, mask = _targets(images, edge_masks, view_sel, ray_idx)
        B, R = rgb.shape[0], rgb.shape[1]
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
    grads = _grads(loss, state, cfg, params)
    with tracing.span("step.reduce"):
        grads, metrics = reduce_step(mesh, grads, report, sq_sum, counts[2],
                                     render_stats, partial)
    _update(state, cfg, s, grads, params)
    return metrics, grads


def _rays(state: TrainState, cfg: StepConfig, pose_base, intr_inv, intr,
          view_sel, ray_idx):
    """The step's ray centres and directions [B, R, 3]: the selected
    views' poses (refined under pose optimisation), their rays
    ``ray_idx``, in NDC under ``cfg.ndc``."""
    pose = compose_train_pose(state.se3_refine, pose_base, view_sel,
                              cfg.pose_opt)
    centers, dirs = get_center_and_ray(cfg.H, cfg.W, pose,
                                       intr_inv[view_sel], ray_idx=ray_idx)
    if cfg.ndc:
        centers, dirs = convert_ndc(centers, dirs, intr[view_sel],
                                    near=cfg.ndc_near_plane)
    return centers, dirs


def _render(field, cfg: StepConfig, vm_cfg, centers, dirs, s: StepScalars,
            jitter, generator, alpha_mask, render_stats, bg_coin):
    """render_rays on the step's rays -> (rgb [B, R, 3], depth [B*R])."""
    B, R = centers.shape[0], centers.shape[1]
    rgb, depth, _ = render_rays(
        field, vm_cfg, cfg.render_config(), centers.reshape(-1, 3),
        dirs.reshape(-1, 3), s.near_far, blur=cfg.blur,
        c2f_density=s.c2f_density, c2f_color=s.c2f_color,
        view_pe_progress=s.view_pe_progress,
        fea_pe_progress=s.fea_pe_progress, ray_jitter=jitter,
        generator=generator, alpha_mask=alpha_mask, stats=render_stats,
        bg_coin=bg_coin)
    return rgb.reshape(B, R, 3), depth


def _targets(images, edge_masks, view_sel, ray_idx):
    """The step's target colours [B, R, 3] and edge mask [B, R]: the small
    ray subset first, then the views."""
    return images[:, ray_idx][view_sel], edge_masks[:, ray_idx][view_sel]


def _loss(field, cfg: StepConfig, s: StepScalars, rgb, depth, target, mask):
    """The unsharded step's loss (the edge-weighted render loss, the
    regularisers, the depth TV on the grid strategy) and plain MSE."""
    loss = losses.edge_weighted_render_loss(
        rgb, target, mask, s.edge_factor, s.non_edge_factor, s.use_edge)
    plain_mse = losses.mse(rgb, target)
    loss = add_regularizers(loss, field, s)
    if cfg.grid_hw is not None:
        gh, gw = cfg.grid_hw
        loss = loss + s.tv_depth_weight * losses.depth_tv_loss(
            depth.reshape(rgb.shape[0], rgb.shape[1]), gh, gw)
    return loss, plain_mse


def _grads(loss, state: TrainState, cfg: StepConfig, params: dict) -> dict:
    """{name: gradient} of the field's parameters ``params`` and, under
    pose optimisation, of "se3_refine"."""
    names = list(params)
    wrt = [params[k] for k in names]
    if cfg.pose_opt:
        wrt.append(state.se3_refine)
    with tracing.span("step.backward"):
        return dict(zip(names + ["se3_refine"],
                        torch.autograd.grad(loss, wrt)))


def _pose_grad(grads: dict, cfg: StepConfig):
    """The pose table's gradient as it is accumulated: view 0's zeroed
    under pin_first_pose."""
    g_se3 = grads["se3_refine"]
    if cfg.pin_first_pose:
        g_se3 = g_se3.clone()
        g_se3[0] = 0.0
    return g_se3


def float32_leaves(field) -> bool:
    """Every parameter of ``field`` real float32: the leaves
    optim.adam_update_ updates (bf16 factors take adam_update)."""
    return all(p.dtype == torch.float32 for p in field.parameters())


def _update(state: TrainState, cfg: StepConfig, s: StepScalars, grads: dict,
            params: dict, scales: Optional[dict] = None):
    """Both Adams, in place: the field's by optim.adam_update_ (adam_update
    on bf16 leaves), the pose table's on the accumulation cadence
    (pose_do_step) by optim.masked_adam_update_ from the pose-gradient
    accumulator, which is added to and, on a pose step, zeroed in place.
    ``scales``: {"scene": pair, "pose": pair} of optim.adam_scales for the
    Adams' next counts as 0-d tensors (a captured step), else None (host
    floats from the counts).  The counts are the caller's to advance
    (advance_counts)."""
    field = state.field
    with torch.no_grad(), tracing.span("step.adam"):
        lrs = field_lr_tree(field, s.lr_index, s.lr_basis)
        if float32_leaves(field):
            adam_update_(grads, state.scene_opt, params, lrs, b2=cfg.scene_b2,
                         scales=None if scales is None else scales["scene"])
        else:
            new_params, new = adam_update(grads, state.scene_opt, params,
                                          lrs, b2=cfg.scene_b2)
            for k in params:
                params[k].copy_(new_params[k])
            state.scene_opt.mu, state.scene_opt.nu = new.mu, new.nu
        if cfg.pose_opt:
            accum = state.pose_grad_accum
            accum.add_(_pose_grad(grads, cfg))
            do_step = s.pose_do_step > 0
            if not frozen(s.lr_pose):
                masked_adam_update_(
                    {"se3_refine": accum}, state.pose_opt,
                    {"se3_refine": state.se3_refine}, s.lr_pose, do_step,
                    adam_scales(state.pose_opt.count + 1, 0.9, cfg.pose_b2,
                                accum.device)
                    if scales is None else scales["pose"], b2=cfg.pose_b2)
            if isinstance(do_step, torch.Tensor):
                accum.masked_fill_(do_step, 0.0)
            elif do_step:
                accum.zero_()


def advance_counts(state: TrainState, cfg: StepConfig, s: StepScalars):
    """Both Adams' counts after a step: the field's each step, the pose
    table's on its cadence (host scalars)."""
    state.scene_opt.count += 1
    if cfg.pose_opt and s.pose_do_step > 0:
        state.pose_opt.count += 1


def unsharded_step(state: TrainState, cfg: StepConfig,
                   vm_cfg: vm_lib.VMConfig, pose_base, intr_inv, images,
                   edge_masks, view_sel, ray_idx, s: StepScalars,
                   scales: Optional[dict] = None, jitter=None,
                   alpha_mask=None, intr=None, bg_coin=None, generator=None,
                   stats: bool = True):
    """train_step without a mesh, its counts left to advance, and the
    function a CUDA graph captures (train/graph_step.py): no host sync and
    no rebound tensor.  There ``s`` holds the values that move within a
    step shape as 0-d float32 tensors on the device (a TV weight of 0 as
    the host 0.0 that leaves its term out, a learning rate that float32
    rounds to 0 as the host 0.0 that freezes its leaves), ``scales``
    {"scene": pair, "pose": pair} each Adam's bias corrections at its next
    count as optim.adam_scales gives them, 0-d tensors, and ``jitter`` and
    ``bg_coin`` the step's predraw (no generator: nothing is drawn); a
    float32 product with a 0-d tensor gives the bits of one with the host
    float it holds.  -> (metrics, grads): loss, mse, psnr as 0-d tensors
    and, with ``stats``, the render fractions; the gradients, se3_refine's
    under pose optimisation."""
    field = state.field
    render_stats = {} if stats else None
    with tracing.span("step.rays"):
        centers, dirs = _rays(state, cfg, pose_base, intr_inv, intr,
                              view_sel, ray_idx)
    rgb, depth = _render(field, cfg, vm_cfg, centers, dirs, s, jitter,
                         generator, alpha_mask, render_stats, bg_coin)
    with tracing.span("step.loss"):
        target, mask = _targets(images, edge_masks, view_sel, ray_idx)
        loss, plain_mse = _loss(field, cfg, s, rgb, depth, target, mask)
    params = dict(field.named_parameters())
    grads = _grads(loss, state, cfg, params)
    _update(state, cfg, s, grads, params, scales)
    metrics = {"loss": loss.detach(), "mse": plain_mse.detach(),
               "psnr": losses.psnr_from_mse(plain_mse.detach())}
    if stats:
        metrics.update(render_stats)
    return metrics, grads
