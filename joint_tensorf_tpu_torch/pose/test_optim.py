"""Test-time photometric pose optimisation
(counterpart of joint_tensorf_tpu/pose/test_optim.py:27-188): the VM
field's (make_test_time_optimizer) and the MLP-NeRF's
(make_barf_test_time_optimizer).

For each test view a fresh se(3) parameter [1, 6] absorbs the remaining
pose error through ``test_iter`` Adam steps (b2 = 0.999) on the
photometric MSE of ``n_rays`` pixels of a fresh permutation per step, at
lr = lr_init * gamma^it with gamma = (lr_end / lr_init)^(1 / test_iter).
The field is frozen while it runs (its parameters need no gradient), so
the backward pass computes the pose's cotangent alone: the compositor's
backward (K2 on CUDA) runs, and the factor samples' backwards (K6, K7)
form the coordinates' gradients alone; the factor scatters (K3) and the
factor adds do not run.

The ray indices, the stratified jitter and (without a white background)
the background coin come from a torch.Generator, or from a ``draws(it)``
callable given to ``optimize`` (the parity tests feed it JAX's own
draws).  Under NDC the rays are converted with the view's intrinsics.
With ``blur`` (LLFF captures, evaluate.py) the field's factors are
blurred by optim.test_kernel_schedule's value at it / test_iter, for
density and appearance alike.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..geometry import lie, poses as pose_ops
from ..geometry.ndc import convert_ndc
from ..geometry.rays import get_center_and_ray
from ..models import vm as vm_lib
from ..render.renderer import BlurSpec, RenderConfig, render_rays
from ..sched.schedules import interp_schedule
from ..train.barf_trainer import render_mlp_rays
from ..train.losses import mse
from ..train.optim import adam_init, adam_update
from ..utils import tree as tree_lib


@contextlib.contextmanager
def frozen(field: vm_lib.VMField):
    """The field's parameters need no gradient inside the block."""
    flags = [p.requires_grad for p in field.parameters()]
    field.requires_grad_(False)
    try:
        yield field
    finally:
        for p, f in zip(field.parameters(), flags):
            p.requires_grad_(f)


def pose_loss(se3, field, vm_cfg: vm_lib.VMConfig, rcfg: RenderConfig,
              pose, image, intr_inv, near_far, ray_idx, jitter, alpha_mask,
              H: int, W: int, intr=None, bg_coin=None,
              blur: Optional[BlurSpec] = None, c2f: float = 0.0):
    """The photometric MSE of the ``ray_idx`` pixels of one view rendered
    from refine(se3 [1, 6]) o pose [3, 4] with stratified ``jitter``
    (NDC rays with the view's ``intr`` [3, 3] under rcfg.ndc; the factors
    blurred by ``blur`` at ``c2f``)."""
    composed = pose_ops.compose([lie.se3_to_SE3(se3), pose[None]])
    centers, dirs = get_center_and_ray(H, W, composed, intr_inv[None],
                                       ray_idx=ray_idx)
    if rcfg.ndc:
        centers, dirs = convert_ndc(centers, dirs, intr[None],
                                    near=rcfg.ndc_near_plane)
    rgb, _, _ = render_rays(field, vm_cfg, rcfg, centers.reshape(-1, 3),
                            dirs.reshape(-1, 3), near_far, blur=blur,
                            c2f_density=c2f, c2f_color=c2f,
                            ray_jitter=jitter, alpha_mask=alpha_mask,
                            bg_coin=bg_coin)
    return mse(rgb, image[ray_idx])


def make_test_time_optimizer(vm_cfg: vm_lib.VMConfig, rcfg: RenderConfig,
                             H: int, W: int, n_rays: int, test_iter: int,
                             lr_init: float, lr_end: float,
                             generator: Optional[torch.Generator] = None,
                             on_step: Optional[Callable] = None,
                             blur: Optional[BlurSpec] = None,
                             test_kernel_schedule=None):
    """Returns optimize(field, alpha_mask, pose [3,4], image [H*W,3],
    intr_inv [3,3], near_far, draws=None, intr=None) -> (refined pose
    [3,4], final loss).  ``rcfg`` is stratified (is_train=True).
    ``draws(it)`` -> (ray_idx [n_rays] int64, jitter [n_rays, 1] or
    [n_rays, S] under NDC[, background coin]); by default all come from
    ``generator``.  ``intr`` [3,3] converts the rays under NDC.  With
    ``blur`` the factors are blurred at test_kernel_schedule's value.
    ``on_step(it, loss)`` runs after each step with the loss as a 0-d
    device tensor."""
    gamma = (lr_end / lr_init) ** (1.0 / test_iter)

    def default_draws(device):
        def draw(it):
            idx = torch.randperm(H * W, generator=generator,
                                 device=device)[:n_rays]
            jitter = torch.rand(
                (idx.shape[0], rcfg.n_samples if rcfg.ndc else 1),
                generator=generator, device=device)
            coin = (None if rcfg.white_bg else
                    torch.rand((), generator=generator, device=device) < 0.5)
            return idx, jitter, coin
        return draw

    def optimize(field, alpha_mask, pose, image, intr_inv, near_far,
                 draws=None, intr=None):
        dev = pose.device
        draws = draws or default_draws(dev)
        pose = pose.detach()
        se3 = torch.zeros((1, 6), device=dev, requires_grad=True)
        opt_state = adam_init({"se3": se3})
        loss = None
        with frozen(field):
            for it in range(test_iter):
                ray_idx, jitter, *coin = draws(it)
                c2f = (interp_schedule(it / test_iter, test_kernel_schedule)
                       if test_kernel_schedule is not None else 0.0)
                loss = pose_loss(se3, field, vm_cfg, rcfg, pose, image,
                                 intr_inv, near_far, ray_idx, jitter,
                                 alpha_mask, H, W, intr=intr,
                                 bg_coin=coin[0] if coin else None,
                                 blur=blur, c2f=float(c2f))
                g, = torch.autograd.grad(loss, [se3])
                with torch.no_grad():
                    new, opt_state = adam_update(
                        {"se3": g}, opt_state, {"se3": se3},
                        lr_init * gamma ** it, b2=0.999)
                    se3.copy_(new["se3"])
                if on_step:
                    on_step(it, loss.detach())
        with torch.no_grad():
            refined = pose_ops.compose([lie.se3_to_SE3(se3), pose[None]])[0]
        return refined, float(loss.detach())

    return optimize


def render_config(trainer) -> RenderConfig:
    """The render config of evaluate.py's test-time optimisation: stratified
    (whatever nerf.sample_stratified says, as there), the alpha mask if any
    at the JAX RenderConfig's default stride 4 (not tpu.mask_stride), no
    compaction, no dense grid, dense appearance, the view directions and
    points detached; the config's background and NDC choice, with the JAX
    RenderConfig's defaults for the near plane (1) and the simulate flags
    (off).  The head's density with arch.shading.predict_density: JAX's
    config leaves mlp_predict_density off there, and its renderer then
    fails on the head's (rgb, density) pair."""
    return RenderConfig(
        n_samples=trainer.n_samples, is_train=True, mask_stride=4,
        white_bg=bool(trainer.opt.nerf.get("setbg_opaque", True)),
        ndc=trainer.ndc, mlp_predict_density=bool(
            trainer.opt.arch.shading.get("predict_density", False)))


def blur_of_test_kernel(opt):
    """(BlurSpec or None, test_kernel_schedule or None) of evaluate.py: the
    test-kernel blur on LLFF captures when the schedule rises past 1e-3."""
    sched = (opt.optim.get("test_kernel_schedule")
             if opt.data.dataset == "llff" else None)
    blur = None
    if sched and max(sched) > 1e-3:
        blur = BlurSpec(mode="uniform-gaussian",
                        kernel_size=int(opt.c2f_kernel_size))
    return blur, (list(sched) if sched else None)


def make_barf_test_time_optimizer(trainer, H: int, W: int, n_rays: int,
                                  test_iter: int, lr: float,
                                  generator: Optional[torch.Generator] = None,
                                  on_step: Optional[Callable] = None):
    """MLP-NeRF test-time photometric pose optimisation (barf.py:162-197;
    pose/test_optim.py:97-188 of the JAX package): a fresh se(3) [1, 6]
    takes ``test_iter`` Adam steps (b2 = 0.999) at the constant ``lr``
    (evaluate.py passes optim.lr_pose, not lr_pose_test, as JAX does) on
    the photometric MSE of ``n_rays`` pixels of a fresh permutation per
    step, stratified as in training (nerf.sample_stratified), with the
    trainer's MLPs frozen and no density noise; NDC rays and fine sampling
    as the trainer has them.

    Returns optimize(pose [3, 4], image [H*W, 3] of an H x W view,
    intr [3, 3], intr_inv [3, 3], draws=None) -> (refined pose [3, 4],
    final loss).
    ``draws(it)`` -> (ray_idx [n_rays] int64, uniforms [n_rays, S] or
    None); by default both come from ``generator``.  ``on_step(it, loss)``
    runs after each step with the loss as a 0-d device tensor."""
    def default_draws(device):
        def draw(it):
            idx = torch.randperm(H * W, generator=generator,
                                 device=device)[:n_rays]
            u = (torch.rand((idx.shape[0], trainer.n_samples),
                            generator=generator, device=device)
                 if trainer.stratified else None)
            return idx, u
        return draw

    def optimize(pose, image, intr, intr_inv, draws=None):
        dev = pose.device
        draws = draws or default_draws(dev)
        pose = pose.detach()
        frozen_params = {k: v.detach() for k, v in trainer.params.items()}
        mlp = tree_lib.unflatten(frozen_params, "mlp")
        mlp_fine = tree_lib.unflatten(frozen_params, "mlp_fine")
        se3 = torch.zeros((1, 6), device=dev, requires_grad=True)
        opt_state = adam_init({"se3": se3})
        loss = None
        for it in range(test_iter):
            ray_idx, uniforms = draws(it)
            composed = pose_ops.compose([lie.se3_to_SE3(se3), pose[None]])
            centers, dirs = get_center_and_ray(H, W, composed,
                                               intr_inv[None],
                                               ray_idx=ray_idx)
            if trainer.ndc:
                centers, dirs = convert_ndc(centers, dirs, intr[None])
            rgb, rgb_f, _, _ = render_mlp_rays(
                mlp, mlp_fine, trainer.mlp_cfg, centers.reshape(-1, 3),
                dirs.reshape(-1, 3), trainer.near_far, trainer.n_samples,
                trainer.depth_param, trainer.n_fine, trainer.setbg,
                trainer.bgcolor, uniforms=uniforms)
            loss = mse(rgb if rgb_f is None else rgb_f, image[ray_idx])
            g, = torch.autograd.grad(loss, [se3])
            with torch.no_grad():
                new, opt_state = adam_update({"se3": g}, opt_state,
                                             {"se3": se3}, lr, b2=0.999)
                se3.copy_(new["se3"])
            if on_step:
                on_step(it, loss.detach())
        with torch.no_grad():
            refined = pose_ops.compose([lie.se3_to_SE3(se3), pose[None]])[0]
        return refined, float(loss.detach())

    return optimize
