"""Planar (2D) alignment trainer, the paper's fast sanity pipeline
(counterpart of joint_tensorf_tpu/train/planar_trainer.py).

Jointly optimises a neural image (``model: planar_svd``, ``planar_fft``
or ``planar``, the MLP) and one warp per patch (homography or fewer
dof) against perturbed patches of one photo, with the scheduled rank and
component-wise blur (c2f_schedule's kernel_t and rank through
sched/schedules.interp_schedule; reference planar.py:69-130).  Logs PSNR
and warp_error = mean ||warp - warp_pert||, the distance to the true
alignment.

The perturbations are drawn from the numpy generator in JAX's order, each
kept once its crop's corners land inside the image, decided on the host
in float32 as JAX decides it (geometry/warp2d.check_corners_in_range);
the GT patches are sampled from the image with ops/sampling.sample_image.
The image parameters draw from a torch.Generator.  The step is one
autograd step with the reference's Adam (b2 = 0.999; complex leaves step
their real part, train/optim.py), then the first warp is re-zeroed with
warp.fix_first.  As JAX's, train_iteration reads the loss and the mse
back every step (one copy here), so each step synchronises the host.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..geometry import warp2d
from ..models import planar as planar_lib
from ..ops.kernels import average_kernel, gaussian_kernel
from ..ops.sampling import sample_image
from ..sched.schedules import interp_schedule
from ..utils import tree
from ..utils.torch_setup import resolve_device, setup_torch
from .losses import mse
from .optim import adam_init, adam_update


def load_image(opt) -> np.ndarray:
    """[3, H, W] float32 image: data.image_fname resized to
    data.image_size, or a procedural pattern when the file is absent.  The
    file's existence is checked before imageio is imported; JAX imports
    imageio first and catches only FileNotFoundError, so without imageio
    it raises even where the file is absent.  Wherever JAX runs the
    result is the same."""
    H, W = opt.data.image_size
    fname = opt.data.get("image_fname")
    if fname and os.path.exists(fname):
        import imageio.v2 as imageio

        from ..data.base import resize_images

        img = imageio.imread(fname).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3].transpose(2, 0, 1)
        return resize_images(img[None], (H, W))[0]
    # procedural fallback: aperiodic multi-scale structure (random smooth
    # blobs); periodic patterns make the alignment objective ambiguous
    rng = np.random.default_rng(42)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    yn, xn = y / H, x / W
    img = np.full((3, H, W), 0.5, np.float32)
    for _ in range(40):
        cx, cy = rng.uniform(0, 1, 2)
        s = rng.uniform(0.02, 0.25)
        color = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        g = np.exp(-((xn - cx) ** 2 + (yn - cy) ** 2) / (2 * s**2))
        img += color[:, None, None] * g
    return np.clip(img, 0, 1).astype(np.float32)


class PlanarTrainer:
    # the JAX params are a dict ({"image", "warp"}), not a dataclass
    jax_params_dataclass = False

    def __init__(self, opt: Options, device=None):
        setup_torch()
        self.opt = opt
        self.device = dev = resolve_device(device)
        self.it = 0
        self.max_iter = int(opt.max_iter)
        seed = int(opt.get("seed", 0))
        self.rng_np = np.random.default_rng(seed)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)

        self.H, self.W = opt.data.image_size
        self.H_crop, self.W_crop = opt.data.patch_crop
        self.B = int(opt.batch_size)
        self.warp_type = opt.warp.type
        self.dof = int(opt.warp.dof)
        self.fix_first = bool(opt.warp.get("fix_first", True))
        self.image_raw = torch.as_tensor(load_image(opt), device=dev)

        self.model = opt.model      # planar (the MLP) | planar_svd | planar_fft
        if self.model == "planar_svd":
            res_w, res_h = opt.arch.resolution
            self.max_ranks = int(opt.arch.max_ranks)
            image = planar_lib.init_svd_image(self.max_ranks, res_w, res_h,
                                              self.generator, device=dev)
        elif self.model == "planar_fft":
            res_w, res_h = opt.arch.resolution
            self.max_ranks = max(res_w // 5, res_h // 5)
            image = planar_lib.init_fft_image(res_w, res_h, device=dev)
        else:
            self.max_ranks = 0
            image = planar_lib.init_mlp_image(
                [int(x) for x in opt.arch.layers[1:]],
                int(opt.arch.posenc.L_2D), self.generator,
                skip=tuple(opt.arch.get("skip", [])),
                barf_c2f=opt.get("barf_c2f"), device=dev)
        self.params = {k: v.requires_grad_(True) for k, v in tree.flatten(
            {"image": image,
             "warp": torch.zeros((self.B, self.dof), device=dev)}).items()}
        self.opt_state = adam_init(self.params)
        self.warp_pert, self.image_pert = self._generate_perturbations()
        self.grid = warp2d.normalized_pixel_grid_crop(
            self.H, self.W, self.H_crop, self.W_crop, device=dev)
        self.metrics_history: list[dict] = []

    # ---------------------------------------------------------------- setup
    def _generate_perturbations(self):
        """The warp noise [B, dof] and the warped GT patches [B, Hc*Wc, 3]
        (planar.py:104-130)."""
        opt = self.opt
        noise_h = float(opt.warp.noise_h)
        noise_t = float(opt.warp.get("noise_t", 0.0))
        trans = [(0, 0)] + [(x, y) for x in (-noise_t, noise_t)
                            for y in (-noise_t, noise_t)]
        perts = np.zeros((self.B, self.dof), np.float32)
        for i in range(self.B):
            while True:
                p = self.rng_np.normal(size=self.dof).astype(np.float32) * \
                    noise_h
                if self.dof > 1:
                    p[0] += trans[i % len(trans)][0]
                    p[1] += trans[i % len(trans)][1]
                if warp2d.check_corners_in_range(
                        torch.as_tensor(p)[None], self.warp_type, self.H,
                        self.W, self.H_crop, self.W_crop):
                    break
            perts[i] = p
        if self.fix_first:
            perts[0] = 0
        perts = torch.as_tensor(perts, device=self.device)
        grid = warp2d.normalized_pixel_grid_crop(
            self.H, self.W, self.H_crop, self.W_crop, device=self.device)
        warped = warp2d.warp_grid(grid.expand((self.B,) + grid.shape), perts,
                                  self.warp_type)
        s = max(self.H, self.W)
        warped = torch.stack([warped[..., 0] * s / self.W,
                              warped[..., 1] * s / self.H], dim=-1)
        patches = torch.stack([sample_image(self.image_raw, c)
                               for c in warped])
        return perts, patches

    def image_params(self, params: Optional[dict] = None):
        return tree.unflatten(self.params if params is None else params,
                              "image")

    def _image_forward(self, image, coords, sigma: float, cur_rank,
                       progress: float = 1.0):
        opt = self.opt
        ktype = opt.arch.get("kernel_type", "none")
        if self.model == "planar_svd":
            kernel = None
            if ktype in ("gaussian", "average"):
                make = gaussian_kernel if ktype == "gaussian" else \
                    average_kernel
                kernel = make(sigma, int(opt.arch.kernel_size),
                              device=self.device)
            return planar_lib.svd_image_forward(
                image, coords, kernel=kernel, cur_rank=cur_rank,
                interp_before_product=bool(opt.get("interp_before_product",
                                                   False)),
                mode=opt.arch.get("grid_interp", "bilinear"))
        if self.model == "planar_fft":
            # the gaussian for "average" too, as in JAX
            kernel = (gaussian_kernel(sigma, int(opt.arch.kernel_size),
                                      device=self.device)
                      if ktype in ("gaussian", "average") else None)
            return planar_lib.fft_image_forward(image, coords,
                                                cur_rank=cur_rank,
                                                kernel=kernel)
        return planar_lib.mlp_image_forward(
            image, coords, int(opt.arch.posenc.L_2D),
            skip=tuple(opt.arch.get("skip", [])),
            barf_c2f=opt.get("barf_c2f"), progress=progress)

    # ----------------------------------------------------------------- step
    def loss(self, params: dict, sigma: float, cur_rank: int,
             progress: float):
        """(loss, render mse) of the patches warped by params["warp"]."""
        opt = self.opt
        warped = warp2d.warp_grid(self.grid.expand((self.B,) +
                                                   self.grid.shape),
                                  params["warp"], self.warp_type)
        image = self.image_params(params)
        rgb = self._image_forward(image, warped, sigma, cur_rank, progress)
        render_mse = mse(rgb, self.image_pert)
        loss = 10.0 ** float(opt.loss_weight.get("render", 0)) * render_mse
        tv_w = opt.loss_weight.get("total_variance")
        if tv_w is not None and self.model == "planar_svd":
            loss = loss + 10.0 ** float(tv_w) * planar_lib.svd_tv_loss(
                image, self.max_ranks)
        elif tv_w is not None and self.model == "planar_fft":
            loss = loss + 10.0 ** float(tv_w) * planar_lib.fft_parseval_loss(
                image)
        return loss, render_mse

    def schedule(self):
        """This iteration's (blur sigma, rank)."""
        sigma = 0.0
        cur_rank = self.max_ranks
        c2f = self.opt.get("c2f_schedule")
        if c2f is not None:
            if c2f.get("kernel_t") is not None:
                sigma = interp_schedule(self.progress, c2f.kernel_t)
            if c2f.get("rank") is not None:
                cur_rank = int(interp_schedule(self.progress, c2f.rank))
        return sigma, cur_rank

    def step(self, sigma: float, cur_rank: int):
        """One Adam step at blur ``sigma`` and rank ``cur_rank`` -> (loss,
        render mse) as 0-d device tensors."""
        names = list(self.params)
        loss, render_mse = self.loss(self.params, sigma, cur_rank,
                                     self.progress)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [self.params[k] for k in names])))
        lrs = {k: float(self.opt.optim.lr_warp) if k == "warp"
               else float(self.opt.optim.lr) for k in names}
        with torch.no_grad():
            new, self.opt_state = adam_update(grads, self.opt_state,
                                              self.params, lrs, b2=0.999)
            if self.fix_first:
                new["warp"][0] = 0.0
            for k in names:
                self.params[k].copy_(new[k])
        return loss.detach(), render_mse.detach()

    @property
    def progress(self):
        return self.it / self.max_iter

    def train_iteration(self) -> dict:
        sigma, cur_rank = self.schedule()
        loss, m = torch.stack(self.step(sigma, cur_rank)).tolist()
        return {"loss": loss, "mse": m,
                "psnr": float(-10 * np.log10(max(m, 1e-12))),
                "sigma": float(sigma), "rank": cur_rank}

    def warp_error(self) -> float:
        d = (self.params["warp"].detach() - self.warp_pert).cpu().numpy()
        return float(np.linalg.norm(d, axis=-1).mean())

    def run(self, max_iter: Optional[int] = None, log_every: int = 100,
            callback=None):
        end = self.max_iter if max_iter is None else max_iter
        t0 = time.time()
        while self.it < end:
            m = self.train_iteration()
            if self.it % log_every == 0:
                if not math.isfinite(float(m.get("loss", 0.0))):
                    raise FloatingPointError(
                        f"non-finite loss {float(m['loss'])} at it {self.it}")
                m.update(it=self.it, warp_error=self.warp_error(),
                         wall=time.time() - t0)
                self.metrics_history.append(m)
                if callback:
                    callback(self, m)
            self.it += 1
        return self.metrics_history

    @torch.no_grad()
    def predict_entire_image(self) -> np.ndarray:
        """[H, W, 3] of the current image at the full rank and this
        iteration's blur (planar.py:146-151)."""
        grid = warp2d.normalized_pixel_grid(self.H, self.W,
                                            device=self.device)[None]
        sigma = 0.0
        c2f = self.opt.get("c2f_schedule")
        if c2f is not None and c2f.get("kernel_t") is not None:
            sigma = interp_schedule(self.progress, c2f.kernel_t)
        rgb = self._image_forward(self.image_params(), grid, sigma,
                                  self.max_ranks)
        return rgb.reshape(self.H, self.W, 3).cpu().numpy()
