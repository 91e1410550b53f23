"""Plain float32 PyTorch of BARF's training step (Lin et al., ICCV 2021,
bundle-adjusting NeRF; github.com/chenhsuanlin/bundle-adjusting-NeRF,
model/nerf.py and model/barf.py), the reference that decides a BARF
cell's ``correct``.

``Reference(inputs, device).run(n)`` starts from what the benchmark handed
both sides (the MLP's weights, the images, the GT poses and the pose
noise, the seed, the first iteration) and works out ``n`` steps:

* the poses: the se(3) noise and the per-view refinement through the
  exponential map, composed onto the GT poses;
* the rays of ``nerf.n_rays`` // V pixels of every view
  (``all_view_rand_rays``) through the pixel centres;
* ``nerf.sample_intvs`` stratified depths on ``nerf.depth.range``;
* the positional encoding (sin and cos of 2^k pi x, k < L) with BARF's
  coarse-to-fine band weights at progress it / max_iter over ``barf_c2f``;
* the feature MLP (``arch.layers_feat``, the encoded points concatenated
  again at each layer of ``arch.skip``), the density from the last
  layer's first channel through softplus, the RGB head on the features and
  the encoded view direction, sigmoid;
* the quadrature with a 1e10 last interval and the opaque background
  (``nerf.setbg_opaque``, ``data.bgcolor``);
* the MSE, its gradients by autograd, and Adam (b1 0.9, b2 0.999, eps
  1e-8) on the MLP at ``optim.lr`` and on the pose table at
  ``optim.lr_pose``, each decaying exponentially to its ``_end`` over
  ``max_iter``.

Departures from BARF's published description, each the benchmark's:

* the pixels come from numpy's default_rng(seed) (one permutation a step,
  shared by the views, as BARF's one torch.randperm is) and the stratified
  uniforms from a torch.Generator(seed) on the device, [rays, S], so that
  both sides draw the same;
* the step starts from untrained weights with Adam's moments at zero at
  the cell's first iteration (``start_it``), with the learning rates
  ExponentialLR gives there; BARF's run would reach it trained, with
  moments and bias corrections of ``start_it`` steps;
* one MLP (no fine sampling) and no density noise, as
  options/barf_blender.yaml sets; the reference refuses other settings.

Matmuls run in float32 with TF32 off unless ``tf32`` (the control).
``fault`` plants one of the faults the benchmark's check must catch:
"half_batch" (the loss over the first half of each view's rays) or
"answer" (every rendered colour raised by 1e-3).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .step import Inputs, compose, exp_se3, get

B1, B2, EPS = 0.9, 0.999, 1e-8


def encode(x, L: int, c2f, progress: float):
    """[..., D] -> [..., 2 D L] ([..., D, 2, L]: sin then cos of
    2^k pi x), each band k weighted by (1 - cos(pi clamp(alpha - k, 0,
    1))) / 2, alpha = (progress - start) / (end - start) L."""
    freq = 2.0 ** torch.arange(L, dtype=torch.float32,
                               device=x.device) * math.pi
    spec = x[..., None] * freq
    enc = torch.stack([spec.sin(), spec.cos()], -2)       # [..., D, 2, L]
    if c2f is not None:
        alpha = (progress - c2f[0]) / (c2f[1] - c2f[0]) * L
        k = torch.arange(L, dtype=torch.float32, device=x.device)
        enc = enc * (1 - torch.cos(torch.clamp(alpha - k, 0, 1)
                                   * math.pi)) / 2
    return enc.flatten(-3)


class Reference:
    def __init__(self, inputs: Inputs, device, tf32: bool = False,
                 fault: Optional[str] = None):
        o = inputs.opt
        if o["model"] != "barf":
            raise NotImplementedError("this reference runs BARF")
        if get(o, "nerf.fine_sampling") or get(o, "nerf.density_noise_reg"):
            raise NotImplementedError("fine sampling, density noise")
        if o["nerf"]["ray_sampling_strategy"] != "all_view_rand_rays":
            raise NotImplementedError(o["nerf"]["ray_sampling_strategy"])
        self.x, self.o = inputs, o
        self.dev = torch.device(device)
        self.tf32, self.fault = tf32, fault
        self.V, _, self.H, self.W = inputs.images.shape
        arch = o["arch"]
        self.L3, self.Lv = (int(arch["posenc"]["L_3D"]),
                            int(arch["posenc"]["L_view"]))
        self.skip = tuple(int(s) for s in arch["skip"])
        self.n_feat = len(arch["layers_feat"]) - 1
        self.n_rgb = len(arch["layers_rgb"]) - 1
        self.c2f = tuple(o["barf_c2f"]) if o.get("barf_c2f") else None

    # ------------------------------------------------------------ the step
    def _rays(self, se3, pix):
        pose = compose(exp_se3(se3), self.base)               # [V, 3, 4]
        x = torch.as_tensor(pix % self.W, dtype=torch.float32,
                            device=self.dev) + 0.5
        y = torch.as_tensor(pix // self.W, dtype=torch.float32,
                            device=self.dev) + 0.5
        grid = torch.stack([x, y, torch.ones_like(x)], -1)       # [R, 3]
        cam = grid[None] @ self.intr_inv.transpose(-1, -2)       # [V, R, 3]
        R, t = pose[..., :3], pose[..., 3:]
        dirs = cam @ R                       # R^T x in rows: world frame
        centers = (-(t.transpose(-1, -2) @ R)).expand(dirs.shape)
        return centers.reshape(-1, 3), dirs.reshape(-1, 3)

    def _mlp(self, p, pts, view, progress):
        pts_enc = torch.cat([pts, encode(pts, self.L3, self.c2f, progress)],
                            -1)
        feat = pts_enc
        for li in range(self.n_feat):
            if li in self.skip:
                feat = torch.cat([feat, pts_enc], -1)
            feat = feat @ p[f"mlp.feat.{li}.w"] + p[f"mlp.feat.{li}.b"]
            if li == self.n_feat - 1:
                density = torch.nn.functional.softplus(feat[..., 0])
                feat = feat[..., 1:]
            feat = torch.relu(feat)
        view_enc = torch.cat([view, encode(view, self.Lv, self.c2f,
                                           progress)], -1)
        feat = torch.cat([feat, view_enc], -1)
        for li in range(self.n_rgb):
            feat = feat @ p[f"mlp.rgb.{li}.w"] + p[f"mlp.rgb.{li}.b"]
            if li < self.n_rgb - 1:
                feat = torch.relu(feat)
        return torch.sigmoid(feat), density

    def _render(self, p, centers, dirs, uniforms, progress):
        near, far = (float(v) for v in self.o["nerf"]["depth"]["range"])
        S = uniforms.shape[1]
        depth = (uniforms + torch.arange(S, device=self.dev)) / S \
            * (far - near) + near                                  # [N, S]
        pts = centers[:, None] + dirs[:, None] * depth[..., None]
        unit = dirs / dirs.norm(dim=-1, keepdim=True)
        rgb_s, sigma = self._mlp(p, pts, unit[:, None].expand(pts.shape),
                                 progress)
        intv = torch.cat([depth[:, 1:] - depth[:, :-1],
                          torch.full_like(depth[:, :1], 1e10)], -1)
        sd = sigma * intv * dirs.norm(dim=-1, keepdim=True)
        alpha = 1 - torch.exp(-sd)
        T = torch.exp(-torch.cumsum(torch.cat(
            [torch.zeros_like(sd[:, :1]), sd[:, :-1]], -1), -1))
        w = T * alpha
        rgb = (rgb_s * w[..., None]).sum(1)
        if self.o["nerf"].get("setbg_opaque"):
            bg = float(self.o["data"].get("bgcolor") or 1)
            rgb = rgb + bg * (1 - w.sum(1, keepdim=True))
        if self.fault == "answer":
            rgb = rgb + 1e-3
        return rgb

    def _lrs(self, it: int) -> tuple:
        op, n = self.o["optim"], int(self.o["max_iter"])

        def lr(start, end):
            return start * (end / start) ** (it / n) if end else start
        return (lr(float(op["lr"]), op.get("lr_end")),
                lr(float(op["lr_pose"]), op.get("lr_pose_end")))

    def run(self, n_steps: int = 3) -> dict:
        """``n_steps`` steps from the cell's first iteration ->
        {"losses", "grad_norms" (first step, by leaf), "change_norms"
        (after the last step), "rays", "samples", "n_params"}."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            return self._run(n_steps)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _run(self, n_steps: int) -> dict:
        x, dev, V = self.x, self.dev, self.V
        images = x.images.to(dev).reshape(V, 3, -1).transpose(1, 2)
        self.intr_inv = torch.as_tensor(x.intr_inv, device=dev)
        gt = torch.as_tensor(x.poses, device=dev)
        self.base = gt if x.noise_se3 is None else compose(
            exp_se3(x.noise_se3.to(dev)), gt)
        p = {k: v.to(dev, torch.float32).clone()
             for k, v in x.weights.items()}
        p["se3_refine"] = torch.zeros((V, 6), device=dev)
        start = {k: v.clone() for k, v in p.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        rng = np.random.default_rng(x.seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(x.seed)
        n_rays = max(1, int(self.o["nerf"]["n_rays"]) // V)
        S = int(self.o["nerf"]["sample_intvs"])
        losses, grad_norms = [], None
        for k in range(n_steps):
            it = x.start_it + k
            pix = rng.permutation(self.H * self.W)[:n_rays]
            uniforms = torch.rand((V * n_rays, S), generator=gen, device=dev)
            for t in p.values():
                t.requires_grad_(True)
            centers, dirs = self._rays(p["se3_refine"], pix)
            rgb = self._render(p, centers, dirs, uniforms,
                               it / int(self.o["max_iter"]))
            target = images[:, torch.as_tensor(pix, device=dev)]  # [V,R,3]
            rgb = rgb.reshape(V, n_rays, 3)
            if self.fault == "half_batch":
                rgb, target = rgb[:, :n_rays // 2], target[:, :n_rays // 2]
            loss = 10.0 ** float(self.o["loss_weight"].get("render") or 0) \
                * torch.mean((rgb - target) ** 2)
            g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            if grad_norms is None:
                grad_norms = {k: float(torch.linalg.vector_norm(t))
                              for k, t in g.items()}
            losses.append(float(loss.detach()))
            lr, lr_pose = self._lrs(it)
            bc1, bc2 = 1 - B1 ** (k + 1), 1 - B2 ** (k + 1)
            with torch.no_grad():
                for name, t in p.items():
                    t.requires_grad_(False)
                    rate = lr_pose if name == "se3_refine" else lr
                    m[name] = B1 * m[name] + (1 - B1) * g[name]
                    v2[name] = B2 * v2[name] + (1 - B2) * g[name] ** 2
                    t -= rate * (m[name] / bc1) / (
                        torch.sqrt(v2[name] / bc2) + EPS)
        change = {k: float(torch.linalg.vector_norm(p[k] - start[k]))
                  for k in p}
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change, "rays": V * n_rays, "samples": S,
                "n_params": sum(t.numel() for t in p.values())}
