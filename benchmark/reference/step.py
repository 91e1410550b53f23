"""Plain float32 PyTorch of BAT's schedule and training step (Joint-TensoRF
on TensoRF; BARF's camera model and se(3) pose refinement), the reference
that decides a cell's ``correct``.

``Reference(inputs).run(n)`` starts from what the benchmark handed both
sides (the weights at the initial resolution with their warm start, the
images, the GT poses and pose noise, the seed) and works out the rest:

* the schedule up to the cell's first iteration without training steps:
  the voxel upsamples (align corners), the alpha-mask updates (at the
  capped resolution past tpu.mask_cap_voxels), the learning rates, the TV
  weights and their decay;
* each step's host inputs, drawn as the trainer draws them from
  numpy's default_rng(seed) (2D blur scale, density blur scale, the ray
  grid's offsets) and torch.Generator(seed) on the device (stratified
  jitter, background coin);
* the step: composed poses, pinhole rays (NDC under camera.ndc), samples
  gated by the box and the alpha mask, the blurred factors, density,
  compositing with the weight gate, appearance of every gated sample, the
  2D-blurred targets and the Sobel edge weights, the loss with density L1
  and the planes' TV, the gradients by autograd, Adam on the field and the
  pose table.

* the budgets of the configured ``tpu:`` path, by the probes of the
  Joint-TensoRF TPU design as the configuration states them: the in-box
  budget (4096 probe rays from default_rng(seed + 12345), pad 1), the
  masked budget and the raised appearance cap at each mask update (probe
  rays from the training generator, default_rng(seed)), and in the step
  the mask probed at each group of ``tpu.mask_stride`` samples, the first
  K / stride live groups of a ray kept, and the ``app_k`` samples of
  largest weight among the gated ones shaded.

Matmuls and convolutions run in float32 with TF32 off
unless ``tf32`` (the control).  ``fault`` plants one of the faults the
benchmark's correctness check must catch: "half_batch" (the loss over
half of the rays) or "answer" (every rendered colour raised by 1e-3).
``nudge`` moves every training sample along its ray by that share of its
depth, a rounding-level move that shows where the function itself has
kinks (a sample crossing a cell boundary of the piecewise-linear factors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import field as fld
from . import images as img

FACTORS = ("density_planes", "density_lines", "app_planes", "app_lines")


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands to both sides."""
    opt: dict                      # the configuration as run
    images: torch.Tensor           # [V, 3, H, W]
    poses: np.ndarray              # GT world->cam [V, 3, 4]
    intr: np.ndarray               # [V, 3, 3]
    intr_inv: np.ndarray
    weights: dict                  # name -> tensor, initial resolution
    noise_se3: Optional[torch.Tensor]   # [V, 6] or None
    seed: int
    start_it: int


def get(opt: dict, dotted: str, default=None):
    node = opt
    for part in dotted.split("."):
        if not isinstance(node, dict) or node.get(part) is None:
            return default
        node = node[part]
    return node


def interp(x: float, sched) -> float:
    return float(np.interp(x, np.linspace(0.0, 1.0, len(sched)), sched))


def voxel_list(n0: int, n1: int, n_up: int):
    return np.round(np.exp(np.linspace(math.log(n0), math.log(n1),
                                       n_up + 1))).astype(np.int64)[1:]


def resolution(aabb, n_voxels: int):
    ext = aabb[1] - aabb[0]
    size = (ext.prod() / n_voxels) ** (1.0 / 3.0)
    return [int(r) for r in (ext / size + 1e-6).astype(np.int64)]


def capped(res, cap: int):
    vol = res[0] * res[1] * res[2]
    if vol <= cap:
        return list(res)
    s = (cap / vol) ** (1.0 / 3.0)
    return [max(1, int(r * s)) for r in res]


def step_size(aabb, res, ratio: float) -> float:
    return float(((aabb[1] - aabb[0]) / (np.asarray(res, np.float64) - 1))
                 .mean() * ratio)


def _series(th2, offset: int, nth: int = 10):
    """sum_i (-1)^i th2^i / (2i + offset)!"""
    out = torch.zeros_like(th2)
    for i in range(nth + 1):
        out = out + (-1) ** i * th2 ** i / float(
            math.factorial(2 * i + offset))
    return out


def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(wu):
    """se(3) [..., 6] -> [R | t] [..., 3, 4] (BARF's Taylor forms)."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    th2 = (w * w).sum(-1)[..., None, None]
    A, B, C = _series(th2, 1), _series(th2, 2), _series(th2, 3)
    eye = torch.eye(3, device=wu.device)
    R = eye + A * wx + B * wx @ wx
    V = eye + B * wx + C * wx @ wx
    return torch.cat([R, V @ u[..., None]], -1)


def compose(a, b):
    """x -> b(a(x)) of world->cam poses [..., 3, 4]."""
    R = b[..., :3] @ a[..., :3]
    t = b[..., :3] @ a[..., 3:] + b[..., 3:]
    return torch.cat([R, t], -1)


def _weights(alpha):
    """Compositing weights alpha * T, T the exclusive product of
    1 - alpha + 1e-10."""
    T = torch.cumprod(1.0 - alpha + 1e-10, -1)
    return alpha * torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], -1)


class Reference:
    def __init__(self, inputs: Inputs, device, tf32: bool = False,
                 fault: Optional[str] = None, nudge: float = 0.0):
        self.x = inputs
        self.o = inputs.opt
        self.dev = torch.device(device)
        self.tf32 = tf32
        self.fault = fault
        self.nudge = nudge
        o = self.o
        if o["model"] != "bat":
            raise NotImplementedError("the reference runs BAT")
        self.ndc = bool(get(o, "camera.ndc", False))
        self.thres = float(o["arch"]["tensorf"]["rayMarch_weight_thres"])
        self.fea2dense = str(o["arch"]["feature_to_density_activation"])
        self.shift = float(o["arch"]["density_shift"])
        self.dscale = float(o["arch"]["distance_scale"])
        sh = o["arch"]["shading"]
        self.head = (str(sh["model"]), int(sh["view_pe"]), int(sh["fea_pe"]))
        self.V, _, self.H, self.W = inputs.images.shape

    # ------------------------------------------------------- the schedule
    def _field(self):
        return {g: [self.p[f"{g}.{i}"] for i in range(3)] for g in FACTORS}

    @torch.no_grad()
    def replay(self):
        """The field, box, mask, resolution and samples a ray at the
        cell's first iteration."""
        o, ts = self.o, self.o["train_schedule"]
        self.aabb_np = np.asarray(o["data"]["scene_bbox"], np.float32
                                  ).reshape(2, 3).astype(np.float64)
        self.aabb = torch.as_tensor(self.aabb_np, dtype=torch.float32,
                                    device=self.dev)
        self.p = {k: v.to(self.dev, torch.float32).clone()
                  for k, v in self.x.weights.items()}
        res = resolution(self.aabb_np, int(ts["n_voxel_init"]))
        ups = list(ts["upsample_iters"])
        masks = list(ts.get("update_alphamask_iters") or [])
        voxels = list(voxel_list(int(ts["n_voxel_init"]),
                                 int(ts["n_voxel_final"]), len(ups)))
        ratio = float(o["nerf"]["step_ratio"])
        cap = int(get(o, "tpu.mask_cap_voxels", 256 ** 3))
        tpu = o.get("tpu") or {}
        self.stride = int(tpu.get("mask_stride", 4))
        seed0 = int(o.get("seed") or 0)
        rng_train = np.random.default_rng(seed0)
        self.mask, self.k_mask, self.app_k_dyn = None, None, None
        self.res = res
        self.S = self._n_samples(res)
        for it in sorted(set(ups + masks)):
            if it >= self.x.start_it:
                break
            if it in ups:
                res = resolution(self.aabb_np, int(voxels.pop(0)))
                f = fld.upsample(self._field(), res)
                for g in FACTORS:
                    for i in range(3):
                        self.p[f"{g}.{i}"] = f[g][i]
                self.res, self.S = res, self._n_samples(res)
            if it in masks:
                big = res[0] * res[1] * res[2] >= cap
                if not big and it == masks[0] and ts.get(
                        "shrink_bbox_with_alphamask", True):
                    raise NotImplementedError("the reference does not "
                                              "shrink the box")
                self.mask = fld.alpha_mask(
                    self._field(), self.aabb, capped(res, cap),
                    step_size(self.aabb_np, res, ratio),
                    float(ts.get("alpha_mask_threshold", 1e-4)),
                    self.fea2dense, self.shift)
                self.k_mask = self._probe_k(rng_train, 1.25, self.mask)
                self.app_k_dyn = self._probe_app_k(rng_train, it)
        self.k_bbox = (self._probe_k(np.random.default_rng(seed0 + 12345),
                                     1.0, None)
                       if tpu.get("bbox_compact", True) else None)
        self.last_up = max([u for u in ups if u < self.x.start_it],
                           default=None)

    def _n_samples(self, res) -> int:
        return min(int(self.o["nerf"]["sample_intvs"]), int(
            np.linalg.norm(np.asarray(res, np.float64))
            / float(self.o["nerf"]["step_ratio"])))

    def _near(self, it: int) -> float:
        o = self.o
        near = float(o["nerf"]["depth"]["range"][0])
        if o["data"]["dataset"] != "blender" and \
                o.get("tensorf_near_plane_schedule") is not None:
            near = interp(it / int(o["max_iter"]),
                          o["tensorf_near_plane_schedule"])
        return near

    def _probe_rays(self, rng):
        """Every view's first 4096 / V pixels of one permutation, at the
        poses before any step (no refinement)."""
        per_view = max(1, 4096 // self.V)
        pix = rng.permutation(self.H * self.W)[:per_view]
        zero = torch.zeros((self.V, 6), device=self.dev)
        return self._rays(zero, pix)

    def _grid_samples(self, centers, dirs, near, far):
        """Unjittered samples: (pts [n, S, 3], z [n, S], in box [n, S])."""
        n, S = centers.shape[0], self.S
        vec = torch.where(dirs == 0, torch.full_like(dirs, 1e-6), dirs)
        t_min = torch.minimum((self.aabb[1] - centers) / vec,
                              (self.aabb[0] - centers) / vec).amax(-1)
        z = t_min.clamp(near, far)[:, None] + self._step_len() * \
            torch.arange(S, device=self.dev)[None]
        pts = centers[:, None] + dirs[:, None] * z[..., None]
        inb = ((pts >= self.aabb[0]) & (pts <= self.aabb[1])).all(-1)
        return pts, z, inb

    def _step_len(self):
        return ((self.aabb[1] - self.aabb[0]) / (torch.as_tensor(
            self.res, device=self.dev, dtype=torch.float32) - 1)).mean() \
            * float(self.o["nerf"]["step_ratio"])

    @torch.no_grad()
    def _probe_k(self, rng, pad: float, mask):
        """The compaction budget: the most live sample slots of a probe
        ray (live groups of ``mask_stride``: any sample in the box, and
        the mask at the group's first sample) x ``pad``, up to a multiple
        of 128, at least 128; None where it would reach S.  None under
        NDC."""
        if self.ndc:
            return None
        centers, dirs = self._probe_rays(rng)
        S = self.S
        g = self.stride if self.stride > 1 and S % self.stride == 0 else 1
        pts, _, inb = self._grid_samples(
            centers, dirs, *(float(v) for v in self.o["nerf"]["depth"][
                "range"]))
        n = centers.shape[0]
        alive = inb.reshape(n, S // g, g).any(-1)
        if mask is not None:
            alive &= fld.mask_alive(mask, self.aabb, pts[:, ::g].reshape(
                -1, 3)).reshape(n, S // g)
        mx = int(alive.sum(-1).max()) * g
        k = min(S, max(128, -(-int(mx * pad) // 128) * 128))
        return None if k >= S else k

    @torch.no_grad()
    def _probe_app_k(self, rng, it: int):
        """The raised appearance cap: the 0.98 quantile of the probe
        rays' gated sample counts, up to a multiple of 64, within
        [tpu.app_k, tpu.app_k_max]; None where it stays tpu.app_k (no
        probe ray clips there, or it would not rise)."""
        tpu = self.o.get("tpu") or {}
        base = int(tpu["app_k"]) if tpu.get("app_k") else None
        if base is None or not tpu.get("app_k_auto", True):
            return None
        centers, dirs = self._probe_rays(rng)
        pts, z, valid = self._grid_samples(centers, dirs, self._near(it),
                                           float(self.o["nerf"]["depth"][
                                               "range"][1]))
        n, S = valid.shape
        flat = pts.reshape(-1, 3)
        valid &= fld.mask_alive(self.mask, self.aabb, flat).reshape(n, S)
        sigma = fld.feature2density(fld.density_feature(
            self._field(), fld.normalize(flat, self.aabb)), self.fea2dense,
            self.shift).reshape(n, S)
        sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
        dists = torch.cat([z[:, 1:] - z[:, :-1],
                           torch.zeros_like(z[:, :1])], -1)
        w = _weights(1.0 - torch.exp(-sigma * dists * self.dscale))
        n_gate = ((w > self.thres) & valid).sum(-1).cpu().numpy()
        k_q = int(np.quantile(n_gate, 0.98))
        clip = float((n_gate > base).mean())
        k = min(max(base, -(-k_q // 64) * 64), int(tpu.get("app_k_max",
                                                           256)))
        if (k > base and clip == 0.0) or S <= base:
            k = base
        return None if k == base else k

    def _budgets(self, it: int, blurred: bool):
        """(compaction K or None, appearance cap or None, the mask that
        gates the step or None) of this iteration."""
        tpu = self.o.get("tpu") or {}
        app_k = self.app_k_dyn if self.app_k_dyn is not None else (
            int(tpu["app_k"]) if tpu.get("app_k") else None)
        if not blurred and self.k_mask is not None and \
                tpu.get("app_k_dense_only"):
            app_k = None
        ups = list(self.o["train_schedule"]["upsample_iters"])
        if blurred and tpu.get("blur_mask_compact", True) and not self.ndc \
                and (not ups or it >= ups[-1]):
            raise NotImplementedError("the blur-mask budget")
        if blurred or self.k_mask is None:
            return self.k_bbox, app_k, None if blurred else self.mask
        return self.k_mask, app_k, self.mask

    # ---------------------------------------------- per-iteration scalars
    def _scalars(self, it: int) -> dict:
        o, ts, opt = self.o, self.o["train_schedule"], self.o["optim"]
        max_iter = int(o["max_iter"])
        dur = int(opt.get("lr_decay_iters", -1) or -1)
        target = float(opt.get("lr_decay_target_ratio", 0.1))
        decay = target ** (1.0 / (max_iter if dur < 0 else dur))
        if self.last_up is None:
            scale = decay ** it
        else:
            reset = 1.0 if opt.get("lr_upsample_reset", True) else \
                target ** (self.last_up / max_iter)
            scale = reset * decay ** (it - 1 - self.last_up)
        lr_pose = float(opt.get("lr_pose") or 0.0)
        if get(o, "optim.sched_pose.type") == "ExponentialLR" and lr_pose:
            lr_pose *= (float(opt["lr_pose_end"]) / lr_pose) ** (
                it / max_iter)
        elif get(o, "optim.sched_pose.lr_pose_schedule"):
            raise NotImplementedError("pose lr lambda schedule")
        if opt.get("warmup_pose"):
            lr_pose *= min(1.0, it / float(opt["warmup_pose"]))
        masks = list(ts.get("update_alphamask_iters") or [])
        first = masks[0] if masks else max_iter
        l1 = o["loss_weight"].get("L1")
        accum = (int(ts["n_AccumPoseGrad_init"])
                 if it < int(ts.get("change_AccumPoseGrad_after_n_iters",
                                    0) or 0)
                 else int(ts.get("n_AccumPoseGrad_rest",
                                 opt.get("pose_grad_accum_iter", 1))))
        if accum != 1 or ts.get("pin_first_pose"):
            raise NotImplementedError("pose-gradient accumulation, pinning")
        lw = o["loss_weight"]
        if lw.get("TV_depth"):
            raise NotImplementedError("depth TV")
        near, far = self._near(it), float(o["nerf"]["depth"]["range"][1])
        use_edge = 0.0
        if o.get("edge_mask_on_render_loss") and o.get("blur_2d"):
            on = it % 2 == 0 if o.get("alternate_edge_loss") else True
            if on and it < int(o.get("edge_mask_before_iter", 0)):
                use_edge = 1.0
        return {
            "lr_index": float(opt["lr_index"]) * scale,
            "lr_basis": float(opt["lr_basis"]) * scale,
            "lr_pose": lr_pose, "near": near, "far": far,
            "l1": 0.0 if l1 is None else float(
                l1["rest"] if it > first else l1["init"]),
            "tv_d": float(lw.get("TV_density") or 0.0) * decay ** it,
            "tv_c": float(lw.get("TV_color") or 0.0) * decay ** it,
            "use_edge": use_edge,
            "edge": float(o.get("edge_loss_factor", 1.5)),
            "non_edge": float(o.get("non_edge_loss_factor", 0.5))}

    def _draws(self, it: int, rng):
        """(2D scale, density sigma, colour sigma, view pixel indices) in
        the trainer's draw order."""
        o = self.o
        progress = it / int(o["max_iter"])
        d = c = sc2d = 0.0
        if o.get("c2f_mode") not in (None, "None"):
            d = interp(progress, o["c2f_schedule_density"])
            c = interp(progress, o["c2f_schedule_color"])
            if o.get("blur_2d") and o.get("c2f_alternate_2D_blur"):
                sc2d = float(rng.choice(list(
                    o["c2f_alternate_2D_scale_pool"])))
            if o.get("c2f_random_density_blur"):
                if o.get("sync_2d_3d_scales"):
                    raise NotImplementedError("sync_2d_3d_scales")
                d *= float(rng.choice(list(
                    o["c2f_random_density_scale_pool"])))
        ts = o["train_schedule"]
        n_rays = int(o["nerf"]["n_rays"])
        if ts.get("change_n_rays_after_n_iters") is not None:
            n_rays = int(ts["n_rays_init"] if it < int(
                ts["change_n_rays_after_n_iters"]) else ts["n_rays_rest"])
        if o["nerf"]["ray_sampling_strategy"] != "all_view_rand_grid" or \
                ts.get("all_view_sample_after_n_iters") is not None or \
                ts.get("single_view_sample_after_n_iters") is not None:
            raise NotImplementedError("ray strategies but the grid")
        H, W = self.H, self.W
        step = math.ceil((H * W / max(1, n_rays // self.V)) ** 0.5)
        off_x, off_y = int(rng.integers(step)), int(rng.integers(step))
        xs = (off_x + step * np.arange(math.ceil(W / step))) % W
        ys = (off_y + step * np.arange(math.ceil(H / step))) % H
        gx, gy = np.meshgrid(xs, ys)
        return sc2d, d, c, (gx + gy * W).reshape(-1)

    @torch.no_grad()
    def _targets(self, it: int, sc2d: float):
        """(images, edge weights) of this iteration: the 2D blur cache as
        the trainer builds it, at the progress of its refresh (the first
        iteration, then every 500)."""
        o = self.o
        if not o.get("blur_2d"):
            return self.images, torch.zeros_like(self.images[:, 0])
        at = (self.x.start_it if it // 500 == self.x.start_it // 500
              else it // 500 * 500)
        sched = interp(at / int(o["max_iter"]), o["blur_2d_c2f_schedule"])
        if o.get("blur_2d_mode", "uniform-gaussian") != "uniform-gaussian" \
                or o.get("soft_edge_mask"):
            raise NotImplementedError("2D blur mode / soft edges")
        ks = int(o["blur_2d_c2f_kernel_size"])
        key = (at, sc2d)
        if key not in self._cache:
            self._cache[key] = img.blurred(
                self.images, sched * sc2d * (self.W + self.H) / 2, ks)
        e_sc = float(o.get("edge_mask_use_scale", sc2d))
        ekey = ("edge", at, e_sc)
        if ekey not in self._cache:
            self._cache[ekey] = img.hard_edges(
                img.blurred(self.images, sched * e_sc * (self.W + self.H) / 2,
                            ks),
                float(o.get("hard_edge_mask_mean_thresh", 1.25)))
        return self._cache[key], self._cache[ekey]

    # ------------------------------------------------------- the step
    def _rays(self, se3, pix):
        V = self.V
        views = torch.arange(V, device=self.dev)
        pose = compose(exp_se3(se3[views]), self.base)
        x = torch.as_tensor(pix % self.W, dtype=torch.float32,
                            device=self.dev) + 0.5
        y = torch.as_tensor(pix // self.W, dtype=torch.float32,
                            device=self.dev) + 0.5
        grid = torch.stack([x, y, torch.ones_like(x)], -1)       # [R, 3]
        cam = grid[None] @ self.intr_inv.transpose(-1, -2)       # [V, R, 3]
        R, t = pose[..., :3], pose[..., 3:]
        dirs = cam @ R
        centers = (-(t.transpose(-1, -2) @ R)).expand(dirs.shape)
        if self.ndc:
            near = float(get(self.o, "arch.ndc_near_plane", 1.0))
            centers = centers + (near - centers[..., 2:]) / dirs[..., 2:] \
                * dirs
            sx = (self.intr[:, 0, 0] / self.intr[:, 0, 2])[:, None]
            sy = (self.intr[:, 1, 1] / self.intr[:, 1, 2])[:, None]
            cx, cy, cz = centers.unbind(-1)
            rx, ry, rz = dirs.unbind(-1)
            centers = torch.stack([sx * cx / cz, sy * cy / cz,
                                   1 - 2 * near / cz], -1)
            dirs = torch.stack([sx * (rx / rz - cx / cz),
                                sy * (ry / rz - cy / cz), 2 * near / cz], -1)
        return centers.reshape(-1, 3), dirs.reshape(-1, 3)

    def _samples(self, centers, dirs, near, far):
        """(pts [N, S, 3], z [N, S], dists [N, S], viewdirs [N, 3])."""
        n, S = centers.shape[0], self.S
        if self.ndc:
            jit = torch.rand((n, S), generator=self.gen, device=self.dev)
            z = torch.linspace(near, far, S, device=self.dev)[None] + \
                jit * ((far - near) / S)
            norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
            dists = torch.cat([z[:, 1:] - z[:, :-1],
                               torch.zeros_like(z[:, :1])], -1) * norm
            viewdirs = dirs / norm
        else:
            jit = torch.rand((n, 1), generator=self.gen, device=self.dev)
            o_d, d_d = centers.detach(), dirs.detach()
            vec = torch.where(d_d == 0, torch.full_like(d_d, 1e-6), d_d)
            t_min = torch.minimum((self.aabb[1] - o_d) / vec,
                                  (self.aabb[0] - o_d) / vec).amax(-1)
            z = t_min.clamp(near, far)[:, None] + self._step_len() * (
                torch.arange(S, device=self.dev)[None] + jit)
            dists = torch.cat([z[:, 1:] - z[:, :-1],
                               torch.zeros_like(z[:, :1])], -1)
            viewdirs = dirs
        if self.nudge:
            z = z * (1.0 + self.nudge)
        pts = centers[:, None] + dirs[:, None] * z[..., None]
        return pts, z, dists, viewdirs

    def _live(self, pts, inb, K, mask):
        """The samples the step evaluates [n, S]: in the box; with a mask,
        in a group of ``mask_stride`` whose first sample the mask keeps;
        with a budget K < S, in the first K / stride such groups of the
        ray (the first K such samples where S or K does not divide)."""
        n, S = inb.shape
        g = self.stride if S % max(self.stride, 1) == 0 else 1
        K = K if K is not None and K < S else None
        grouped = K is not None and g > 1 and K % g == 0 and not self.ndc
        valid = inb
        group_alive = None
        if mask is not None:
            group_alive = fld.mask_alive(mask, self.aabb, pts[:, ::g].reshape(
                -1, 3)).reshape(n, S // g)
            if not grouped:
                valid = inb & torch.repeat_interleave(group_alive, g, 1)
        elif grouped:
            group_alive = torch.ones((n, S // g), dtype=torch.bool,
                                     device=self.dev)
        if K is None:
            return valid
        if grouped:
            gvalid = group_alive & inb.reshape(n, S // g, g).any(-1)
            keep = gvalid & (torch.cumsum(gvalid.int(), 1) <= K // g)
            return torch.repeat_interleave(keep, g, 1) & inb
        return valid & (torch.cumsum(valid.int(), 1) <= K)

    def _render(self, centers, dirs, sc, blur_d, blur_c, budgets):
        K, app_k, mask = budgets
        n, S = centers.shape[0], self.S
        pts, z, dists, viewdirs = self._samples(centers, dirs, sc["near"],
                                                sc["far"])
        inb = ((pts >= self.aabb[0]) & (pts <= self.aabb[1])).all(-1)
        valid = self._live(pts.detach(), inb, K, mask).reshape(-1)
        flat = pts.reshape(-1, 3)
        f = self._field()
        dp, dl, ap, al = (f[g] for g in FACTORS)
        if blur_d is not None:
            dp, dl = fld.blur_factors(dp, dl, blur_d)
            ap, al = fld.blur_factors(ap, al, blur_c)
        coords = fld.normalize(flat[valid], self.aabb)
        sig = torch.zeros(n * S, device=self.dev)
        sig = sig.index_put((valid.nonzero()[:, 0],), fld.feature2density(
            fld.density_feature({"density_planes": dp, "density_lines": dl},
                                coords), self.fea2dense, self.shift))
        w = _weights(1.0 - torch.exp(-sig.reshape(n, S) * dists
                                     * self.dscale))
        gate = (w > self.thres) & valid.reshape(n, S)
        if app_k is not None:
            score = torch.where(gate, w, torch.zeros_like(w)).detach()
            top = torch.topk(score, min(app_k, S), dim=-1).indices
            gate = gate & torch.zeros_like(gate).scatter_(1, top, True)
        gi = gate.reshape(-1).nonzero()[:, 0]
        feats = fld.app_feature({"app_planes": ap, "app_lines": al},
                                fld.normalize(flat[gi], self.aabb),
                                self.p["basis"])
        vd = viewdirs.detach()[:, None].expand(n, S, 3).reshape(-1, 3)[gi]
        kind, view_pe, fea_pe = self.head
        rgb_s = fld.head(kind, self.p, vd, feats, view_pe, fea_pe)
        rgb = torch.zeros((n * S, 3), device=self.dev).index_put((gi,), rgb_s)
        rgb_map = (w[..., None] * rgb.reshape(n, S, 3)).sum(1)
        acc = w.sum(1)
        if get(self.o, "nerf.setbg_opaque", True):
            rgb_map = rgb_map + (1.0 - acc[:, None])
        else:
            coin = torch.rand((), generator=self.gen, device=self.dev) < 0.5
            rgb_map = rgb_map + coin.float() * (1.0 - acc[:, None])
        if self.fault == "answer":
            rgb_map = rgb_map + 1e-3
        counts = (float(valid.sum()), float(gi.numel()))
        return torch.clamp(rgb_map, 0.0, 1.0), counts

    def _loss(self, rgb, target, edge, sc):
        if self.fault == "half_batch":
            keep = rgb.shape[1] // 2
            rgb, target, edge = rgb[:, :keep], target[:, :keep], \
                edge[:, :keep]

        def mse(a, b):
            return torch.mean((a - b) ** 2)

        m = edge[..., None]
        plain = mse(rgb, target)
        loss = sc["use_edge"] * (
            sc["edge"] * mse(rgb * m, target * m)
            + sc["non_edge"] * mse(rgb * (1 - m), target * (1 - m))) + (
            1.0 - sc["use_edge"]) * plain
        l1 = sum(torch.mean(torch.abs(self.p[f"{g}.{i}"]))
                 for g in ("density_planes", "density_lines")
                 for i in range(3))
        loss = loss + sc["l1"] * l1

        def tv(group):
            return sum(2.0 * (torch.mean((q[1:] - q[:-1]) ** 2)
                              + torch.mean((q[:, 1:] - q[:, :-1]) ** 2))
                       for q in (self.p[f"{group}.{i}"] for i in range(3)))

        if sc["tv_d"]:
            loss = loss + sc["tv_d"] * 1e-2 * tv("density_planes")
        if sc["tv_c"]:
            loss = loss + sc["tv_c"] * 1e-2 * tv("app_planes")
        return loss

    def _adam(self, names, grads, lrs, state, b2, store):
        b1, eps = 0.9, 1e-8
        state["count"] += 1
        c = state["count"]
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        with torch.no_grad():
            for k in names:
                g = grads[k]
                m = state["m"][k] = b1 * state["m"][k] + (1 - b1) * g
                v = state["v"][k] = b2 * state["v"][k] + (1 - b2) * g * g
                store[k] -= lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + eps)

    def run(self, n_steps: int = 3) -> dict:
        """The schedule, then ``n_steps`` steps from the cell's first
        iteration -> {"losses", "grad_norms" (first step, by leaf),
        "change_norms" (after the last step), "counts" ((live, gated)
        samples a step), "rays"}."""
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
        x = self.x
        dev = self.dev
        self.images = x.images.to(dev)
        self.intr = torch.as_tensor(x.intr, device=dev)
        self.intr_inv = torch.as_tensor(x.intr_inv, device=dev)
        gt = torch.as_tensor(x.poses, device=dev)
        self.base = gt if x.noise_se3 is None else compose(
            exp_se3(x.noise_se3.to(dev)), gt)
        self.replay()
        self._cache = {}
        rng = np.random.default_rng(x.seed)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(x.seed)
        names = list(self.p)
        start = {k: v.clone() for k, v in self.p.items()}
        se3 = torch.zeros((self.V, 6), device=dev)
        start["se3_refine"] = se3.clone()
        scene = {"m": {k: torch.zeros_like(v) for k, v in self.p.items()},
                 "v": {k: torch.zeros_like(v) for k, v in self.p.items()},
                 "count": 0}
        pose = {"m": {"se3_refine": torch.zeros_like(se3)},
                "v": {"se3_refine": torch.zeros_like(se3)}, "count": 0}
        losses, counts, grad_norms, blurred = [], [], None, False
        ks = int(self.o.get("c2f_kernel_size", 64))
        size = torch.as_tensor(self.aabb_np[1] - self.aabb_np[0],
                               dtype=torch.float32)
        grid_scale = float((torch.as_tensor(self.res, dtype=torch.float32)
                            / size).mean())
        for k in range(n_steps):
            it = x.start_it + k
            sc = self._scalars(it)
            sc2d, d, c, pix = self._draws(it, rng)
            blur_d = blur_c = None
            if self.o.get("c2f_mode") not in (None, "None") and \
                    max(d, c) >= 1e-3:
                if self.o["c2f_mode"] != "uniform-gaussian":
                    raise NotImplementedError("c2f_mode")
                blur_d = fld.gaussian(grid_scale * d, ks)
                blur_c = fld.gaussian(grid_scale * c, ks)
                blurred = True
            images, edges = self._targets(it, sc2d)
            for v in self.p.values():
                v.requires_grad_(True)
            se3.requires_grad_(True)
            centers, dirs = self._rays(se3, pix)
            rgb, cnt = self._render(centers, dirs, sc, blur_d, blur_c,
                                    self._budgets(it, blur_d is not None))
            pix_t = torch.as_tensor(pix, device=dev)
            target = images.reshape(self.V, 3, -1)[:, :, pix_t].transpose(
                1, 2)
            edge = edges.reshape(self.V, -1)[:, pix_t]
            loss = self._loss(rgb.reshape(self.V, -1, 3), target, edge, sc)
            g = torch.autograd.grad(loss, [self.p[k] for k in names] + [se3])
            grads = dict(zip(names + ["se3_refine"], g))
            for v in self.p.values():
                v.requires_grad_(False)
            se3.requires_grad_(False)
            if grad_norms is None:
                grad_norms = {k: float(torch.linalg.vector_norm(v))
                              for k, v in grads.items()}
            losses.append(float(loss.detach()))
            counts.append(cnt)
            lrs = {k: sc["lr_index"] if k.split(".")[0] in FACTORS
                   else sc["lr_basis"] for k in names}
            self._adam(names, grads, lrs, scene, 0.99, self.p)
            self._adam(["se3_refine"], grads, {"se3_refine": sc["lr_pose"]},
                       pose, 0.999, {"se3_refine": se3})
        now = dict(self.p, se3_refine=se3)
        change = {k: float(torch.linalg.vector_norm(now[k] - start[k]))
                  for k in now}
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change, "counts": counts,
                "rays": int(centers.shape[0]),
                "n_params": sum(v.numel() for v in now.values()),
                "planes": [tuple(self.p[f"density_planes.{i}"].shape[:2])
                           for i in range(3)],
                "lines": [self.p[f"density_lines.{i}"].shape[0]
                          for i in range(3)],
                "blur_taps": (ks // 2 * 2 + 1,) * 2 if blurred else (),
                "budgets": {"k_bbox": self.k_bbox, "k_mask": self.k_mask,
                            "app_k": self.app_k_dyn, "S": self.S}}
