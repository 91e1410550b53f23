"""Test-time photometric pose optimisation, the Euclidean branch
(counterpart of joint_tensorf_tpu/pose/test_optim.py:27-96).

For each test view a fresh se(3) parameter [1, 6] absorbs the remaining
pose error through ``test_iter`` Adam steps (b2 = 0.999) on the
photometric MSE of ``n_rays`` pixels of a fresh permutation per step, at
lr = lr_init * gamma^it with gamma = (lr_end / lr_init)^(1 / test_iter).
The field is frozen while it runs (its parameters need no gradient), so
the backward pass computes the pose's cotangent alone: the compositor's
backward (K2 on CUDA) runs, the factor scatters (K3) do not.

The ray indices and the stratified jitter come from a torch.Generator, or
from a ``draws(it)`` callable given to ``optimize`` (the parity tests feed
it JAX's own draws).  The LLFF test-kernel blur waits with the NDC route.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..geometry import lie, poses as pose_ops
from ..geometry.rays import get_center_and_ray
from ..models import vm as vm_lib
from ..render.renderer import RenderConfig, render_rays
from ..train.losses import mse
from ..train.optim import adam_init, adam_update


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
              H: int, W: int):
    """The photometric MSE of the ``ray_idx`` pixels of one view rendered
    from refine(se3 [1, 6]) o pose [3, 4] with stratified ``jitter``."""
    composed = pose_ops.compose([lie.se3_to_SE3(se3), pose[None]])
    centers, dirs = get_center_and_ray(H, W, composed, intr_inv[None],
                                       ray_idx=ray_idx)
    rgb, _, _ = render_rays(field, vm_cfg, rcfg, centers.reshape(-1, 3),
                            dirs.reshape(-1, 3), near_far, ray_jitter=jitter,
                            alpha_mask=alpha_mask)
    return mse(rgb, image[ray_idx])


def make_test_time_optimizer(vm_cfg: vm_lib.VMConfig, rcfg: RenderConfig,
                             H: int, W: int, n_rays: int, test_iter: int,
                             lr_init: float, lr_end: float,
                             generator: Optional[torch.Generator] = None,
                             on_step: Optional[Callable] = None):
    """Returns optimize(field, alpha_mask, pose [3,4], image [H*W,3],
    intr_inv [3,3], near_far, draws=None) -> (refined pose [3,4], final
    loss).  ``rcfg`` is stratified (is_train=True).  ``draws(it)`` ->
    (ray_idx [n_rays] int64, jitter [n_rays, 1]); by default both come
    from ``generator``.  ``on_step(it, loss)`` runs after each step with
    the loss as a 0-d device tensor."""
    gamma = (lr_end / lr_init) ** (1.0 / test_iter)

    def default_draws(device):
        def draw(it):
            idx = torch.randperm(H * W, generator=generator,
                                 device=device)[:n_rays]
            jitter = torch.rand((idx.shape[0], 1), generator=generator,
                                device=device)
            return idx, jitter
        return draw

    def optimize(field, alpha_mask, pose, image, intr_inv, near_far,
                 draws=None):
        dev = pose.device
        draws = draws or default_draws(dev)
        pose = pose.detach()
        se3 = torch.zeros((1, 6), device=dev, requires_grad=True)
        opt_state = adam_init({"se3": se3})
        loss = None
        with frozen(field):
            for it in range(test_iter):
                ray_idx, jitter = draws(it)
                loss = pose_loss(se3, field, vm_cfg, rcfg, pose, image,
                                 intr_inv, near_far, ray_idx, jitter,
                                 alpha_mask, H, W)
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
    """The render config of evaluate.py's test-time optimisation: stratified,
    the alpha mask if any at the JAX RenderConfig's default stride 4 (not
    tpu.mask_stride), no compaction, no dense grid, dense appearance."""
    return RenderConfig(n_samples=trainer.n_samples, is_train=True,
                        mask_stride=4)
