"""BARF / MLP-NeRF trainer (counterpart of
joint_tensorf_tpu/train/barf_trainer.py:42-342).

Joint pose and coordinate-MLP NeRF (``model: barf``: a per-view se(3)
refinement over poses with optional noise, BARF's c2f positional
encoding), or the MLP-NeRF alone at the given poses (``model: nerf``).
No phases: the shapes stay fixed for the whole run, one autograd step with
the reference's Adam (b2 = 0.999; the MLPs at optim.lr decaying to
lr_end, the pose table at lr_pose decaying to lr_pose_end, with
warmup_pose).  Rays are all views' first n_rays / V pixels of one
permutation, or with single_view_rand_rays n_rays pixels of view it % V,
drawn from the numpy generator in JAX's order; NDC rays under
``camera.ndc``.  With ``nerf.fine_sampling`` a second MLP shades the
union of the coarse depths and n_fine depths drawn from the detached
coarse weights, and the fine branch's PSNR is the one reported.

Device randomness (the pose noise, the MLP init, the stratified depth
uniforms, the density noise) comes from a torch.Generator; a step takes
pre-drawn ``draws`` instead (the parity tests feed JAX's).  The step's
metrics stay on the device: ``run`` reads them at log points only, where
JAX's NaN guard checks the loss.  Evaluation (render_views, validate)
draws nothing: unstratified depths need no draw.  (JAX's render_views
splits the training key once per chunk all the same, so there a
mid-run validation shifts every later stratified draw.)

An iteration is the host's draw (the rays' pixels from the numpy
generator, uploaded through pinned memory, and the device draws) and then
``_step(view_sel, ray_idx, draws)``: the loss, ``torch.autograd.grad``
and Adam, the hook a subclass may wrap.  ``run`` keeps the VM Trainer's
contract (``on_step(trainer, metrics)`` after each step, then
``on_step(trainer, None)``; ``rays_per_step``; ``device``).  Spans
(utils/tracing.py): ``jt.trainer.rays`` around the draw and upload,
``jt.step`` around ``_step``, ``jt.step.rays`` around the pose
composition and the rays (one CUDA graph each way on a card, ``_rays``),
``jt.render`` around ``render_mlp_rays`` with
``jt.render.mlp`` around each MLP call and ``jt.render.composite``
around each quadrature, ``jt.step.backward`` around the gradient and
``jt.step.adam`` around the update (optim.adam_update_: Adam's
operations each once over every leaf, the same bits as adam_update).
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..data.base import SceneData
from ..geometry import align as align_lib
from ..geometry import lie, poses as pose_ops
from ..geometry.ndc import convert_ndc
from ..geometry.rays import get_center_and_ray
from ..models import nerf_mlp
from ..utils import tracing, tree
from ..utils.torch_setup import resolve_device, setup_torch, to_device
from . import losses
from .optim import adam_init, adam_update_


def build_mlp_config(opt: Options) -> nerf_mlp.NerfMLPConfig:
    arch = opt.arch
    posenc = bool(arch.get("posenc"))
    return nerf_mlp.NerfMLPConfig(
        layers_feat=tuple(int(x) for x in arch.layers_feat[1:]),
        layers_rgb=tuple(int(x) for x in arch.layers_rgb[1:]),
        skip=tuple(arch.get("skip", [])),
        L_3D=int(arch.posenc.L_3D) if posenc else 0,
        L_view=int(arch.posenc.L_view) if posenc else 0,
        posenc=posenc,
        view_dep=bool(opt.nerf.get("view_dep", True)),
        density_activ=arch.get("density_activ", "softplus"),
        tf_init=bool(arch.get("tf_init", True)),
        barf_c2f=tuple(opt.barf_c2f) if opt.get("barf_c2f") else None)


@tracing.spanned("render")
def render_mlp_rays(coarse, fine, cfg: nerf_mlp.NerfMLPConfig, c, d,
                    near_far, n_samples: int, depth_param: str, n_fine: int,
                    setbg: bool, bgcolor: float, progress=1.0, uniforms=None,
                    noise=None, noise_fine=None):
    """Render rays c, d [N, 3] with the coarse MLP, and the fine one when
    ``fine`` is given (nerf.Graph.render, nerf.py:698-726).  ``uniforms``
    [N, S]: stratified depth offsets (None: bin centres); ``noise`` [N, S]
    and ``noise_fine`` [N, S + n_fine]: scaled density noise, or None.
    -> (rgb_coarse [N, 3], rgb_fine [N, 3] or None, depth, opacity [N] of
    the branch that shades last)."""
    depth = nerf_mlp.sample_depth(c.shape[0], n_samples, near_far,
                                  depth_param, uniforms, device=c.device)
    ray_unit = d / torch.linalg.norm(d, dim=-1, keepdim=True)

    def shade(params, z, eps):
        pts = c[:, None, :] + d[:, None, :] * z[..., None]
        with tracing.span("render.mlp"):
            rgb_s, dens_s = nerf_mlp.apply_nerf_mlp(
                params, cfg, pts, ray_unit[:, None, :].expand(pts.shape),
                progress=progress, noise=eps)
        with tracing.span("render.composite"):
            return nerf_mlp.composite(d, rgb_s, dens_s, z, setbg, bgcolor)

    rgb, depth_map, opacity, prob = shade(coarse, depth, noise)
    if fine is None:
        return rgb, None, depth_map, opacity
    depth_fine = nerf_mlp.sample_depth_from_pdf(prob.detach(), near_far,
                                                n_fine)
    depth_all, _ = torch.sort(torch.cat(
        [depth.expand(prob.shape), depth_fine], dim=-1), dim=-1)
    rgb_f, depth_map, opacity, _ = shade(fine, depth_all, noise_fine)
    return rgb, rgb_f, depth_map, opacity


class BarfTrainer:
    # the JAX params are a dataclass (BarfParams: .mlp, .se3_refine,
    # .mlp_fine), which names the checkpoint's leaves
    jax_params_dataclass = True

    def __init__(self, opt: Options, train_data: SceneData,
                 val_data: Optional[SceneData] = None, device=None):
        setup_torch()
        self.opt = opt
        self.data = train_data
        self.val_data = val_data
        self.device = dev = resolve_device(device)
        self.it = 0
        self.max_iter = int(opt.max_iter)
        seed = int(opt.get("seed", 0))
        self.rng_np = np.random.default_rng(seed)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.is_barf = opt.model == "barf"
        self.mlp_cfg = build_mlp_config(opt)

        V, H, W = train_data.n_views, train_data.H, train_data.W
        self.n_views, self.H, self.W = V, H, W
        self.gt_poses = torch.as_tensor(train_data.poses, device=dev)
        self.pose_noise: Optional[torch.Tensor] = None
        if self.is_barf and opt.camera.get("noise"):
            se3_noise = torch.randn((V, 6), generator=self.generator,
                                    device=dev) * float(opt.camera.noise)
            self.pose_noise = lie.se3_to_SE3(se3_noise)
        self.pose_base = (self.gt_poses if self.pose_noise is None else
                          pose_ops.compose([self.pose_noise, self.gt_poses]))
        self.images = torch.as_tensor(train_data.images, device=dev).reshape(
            V, 3, H * W).transpose(1, 2).contiguous()             # [V,HW,3]
        self.intr = torch.as_tensor(train_data.intr, device=dev)
        self.intr_inv = torch.as_tensor(train_data.intr_inv, device=dev)
        self.near_far = tuple(float(x) for x in train_data.near_far)

        nerf = opt.nerf
        self.n_samples = int(nerf.sample_intvs)
        self.stratified = bool(nerf.get("sample_stratified", True))
        self.ndc = bool(opt.camera.get("ndc", False))
        self.setbg = bool(nerf.get("setbg_opaque", False))
        self.bgcolor = float(opt.data.get("bgcolor", 1) or 1)
        self.density_noise = float(nerf.get("density_noise_reg") or 0.0)
        self.depth_param = nerf.depth.get("param", "metric")
        self.fine_sampling = bool(nerf.get("fine_sampling", False))
        self.n_fine = int(nerf.get("sample_intvs_fine") or 0)
        # log-scale loss weights (base.py:175: 10**w)
        lw = opt.get("loss_weight", {})
        self.w_render = 10.0 ** float(lw.get("render") or 0.0)
        self.w_fine = (10.0 ** float(lw.get("render_fine"))
                       if lw.get("render_fine") is not None else 0.0)

        params = tree.flatten({
            "mlp": nerf_mlp.init_nerf_mlp(self.mlp_cfg, self.generator, dev),
            "se3_refine": torch.zeros((V, 6), device=dev)})
        if self.fine_sampling:
            params.update(tree.flatten(nerf_mlp.init_nerf_mlp(
                self.mlp_cfg, self.generator, dev), "mlp_fine"))
        self.params = {k: v.requires_grad_(True) for k, v in params.items()}
        self.opt_state = adam_init(self.params)

        # lr schedules (ExponentialLR toward lr_end, nerf.py:48-55)
        o = opt.optim
        self.lr0 = float(o.lr)
        self.lr_gamma = ((float(o.lr_end) / self.lr0) ** (1.0 / self.max_iter)
                         if o.get("lr_end") else 1.0)
        self.lr_pose0 = float(o.get("lr_pose", 0.0) or 0.0)
        self.pose_gamma = ((float(o.lr_pose_end) / self.lr_pose0)
                           ** (1.0 / self.max_iter)
                           if o.get("lr_pose_end") and self.lr_pose0 else 1.0)
        self.warmup_pose = o.get("warmup_pose")
        self.metrics_history: list[dict] = []
        self.rays_per_step = 0
        self._graphed_rays: dict = {}

    # ------------------------------------------------------------ params
    def mlp(self, which: str = "mlp") -> Optional[dict]:
        """The coarse ("mlp") or fine ("mlp_fine") MLP's parameter tree."""
        if which == "mlp_fine" and not self.fine_sampling:
            return None
        return tree.unflatten(self.params, which)

    def _render(self, c, d, progress, draws: dict):
        return render_mlp_rays(
            self.mlp("mlp"), self.mlp("mlp_fine"), self.mlp_cfg, c, d,
            self.near_far, self.n_samples, self.depth_param, self.n_fine,
            self.setbg, self.bgcolor, progress=progress,
            uniforms=draws.get("uniforms"), noise=draws.get("noise"),
            noise_fine=draws.get("noise_fine"))

    # -------------------------------------------------------------- step
    def draw(self, n_rays: int) -> dict:
        """The step's device draws from the trainer's generator: the
        stratified uniforms [N, S] and, with density_noise_reg, the
        density noise [N, S] (and [N, S + n_fine] for the fine MLP), both
        scaled."""
        g, dev, S = self.generator, self.device, self.n_samples
        out = {}
        if self.stratified:
            out["uniforms"] = torch.rand((n_rays, S), generator=g, device=dev)
        if self.density_noise:
            out["noise"] = torch.randn((n_rays, S), generator=g,
                                       device=dev) * self.density_noise
            if self.fine_sampling:
                out["noise_fine"] = torch.randn(
                    (n_rays, S + self.n_fine), generator=g,
                    device=dev) * self.density_noise
        return out

    def loss(self, view_sel, ray_idx, progress, draws: dict):
        """(loss, metrics) of the rays ``ray_idx`` [R] of views
        ``view_sel`` [B] (nerf.py:150-278, barf.py:24-161)."""
        with tracing.span("step.rays"):
            centers, dirs = self._rays(view_sel, ray_idx)
        rgb, rgb_f, _, _ = self._render(centers.reshape(-1, 3),
                                        dirs.reshape(-1, 3), progress, draws)
        target = self.images[view_sel][:, ray_idx].reshape(-1, 3)
        m = losses.mse(rgb, target)
        loss = self.w_render * m
        metrics = {"mse": m, "psnr": losses.psnr_from_mse(m)}
        if rgb_f is not None:
            m_f = losses.mse(rgb_f, target)
            loss = loss + self.w_fine * m_f
            # the fine branch defines the headline PSNR (nerf.py:297)
            metrics = {"mse": m_f, "psnr": losses.psnr_from_mse(m_f),
                       "psnr_coarse": losses.psnr_from_mse(m)}
        return loss, metrics

    def _pose_rays(self, se3_refine, pose_base, intr_inv, intr, view_sel,
                   ray_idx):
        """Centres and directions [B, R, 3] of the rays ``ray_idx`` of the
        views ``view_sel``, each view's pose refined under BARF."""
        base = pose_base[view_sel]
        if self.is_barf:
            refine = lie.se3_to_SE3(se3_refine[view_sel])
            pose = pose_ops.compose([refine, base])
        else:
            pose = base
        centers, dirs = get_center_and_ray(self.H, self.W, pose,
                                           intr_inv[view_sel],
                                           ray_idx=ray_idx)
        if self.ndc:
            centers, dirs = convert_ndc(centers, dirs, intr[view_sel])
        return centers, dirs

    def _rays(self, view_sel, ray_idx):
        """_pose_rays of this step.  On a card under BARF, as one CUDA graph
        forward and one backward, captured at the first step of each shape
        (torch.cuda.make_graphed_callables): the same kernels, but the
        exponential map's Taylor series alone is some 370 small launches a
        step forward and backward, a third of the step's, which left the
        card waiting on the host's issue."""
        args = (self.params["se3_refine"], self.pose_base, self.intr_inv,
                self.intr, view_sel, ray_idx)
        if (self.device.type != "cuda" or not self.is_barf
                or not torch.is_grad_enabled()):
            return self._pose_rays(*args)
        key = (tuple(view_sel.shape), tuple(ray_idx.shape))
        if key not in self._graphed_rays:
            # captured on copies, which each call refills: the pose table's
            # own autograd node is then made on the step's stream (PyTorch
            # still warns once, at the capture, of the copies' nodes)
            sample = tuple(a.detach().clone().requires_grad_(a.requires_grad)
                           for a in args)
            self._graphed_rays[key] = torch.cuda.make_graphed_callables(
                self._pose_rays, sample)
        return self._graphed_rays[key](*args)

    def lrs(self) -> dict:
        """This iteration's per-leaf learning rates (host floats)."""
        lr = self.lr0 * (self.lr_gamma ** self.it)
        lr_pose = self.lr_pose0 * (self.pose_gamma ** self.it)
        if self.warmup_pose:
            lr_pose *= min(1.0, self.it / float(self.warmup_pose))
        return {k: lr_pose if k == "se3_refine" else lr for k in self.params}

    @property
    def progress(self):
        return self.it / self.max_iter

    def _sample_rays(self):
        strat = self.opt.nerf.ray_sampling_strategy
        n_rays = int(self.opt.nerf.n_rays)
        V, H, W = self.n_views, self.H, self.W
        if strat == "single_view_rand_rays":
            view = self.it % V
            return np.array([view]), self.rng_np.permutation(H * W)[:n_rays]
        return np.arange(V), self.rng_np.permutation(H * W)[:max(
            1, n_rays // V)]

    def train_iteration(self, draws: Optional[dict] = None) -> dict:
        """One step: the host's draw (the rays' pixels, uploaded without
        blocking, and ``draws``: pre-drawn uniforms / noise, see draw, else
        drawn from the generator), then ``_step``.  -> metrics as 0-d
        device tensors."""
        with tracing.span("trainer.rays"):
            view_sel, ray_idx = (to_device(a, self.device)
                                 for a in self._sample_rays())
            self.rays_per_step = len(view_sel) * len(ray_idx)
            if draws is None:
                draws = self.draw(self.rays_per_step)
        return self._step(view_sel, ray_idx, draws)

    @tracing.spanned("step")
    def _step(self, view_sel, ray_idx, draws: dict) -> dict:
        """The device step on drawn rays: the loss, its gradient and Adam
        on every leaf, in place (the hook a subclass may wrap).  -> metrics
        as 0-d device tensors."""
        names = list(self.params)
        loss, metrics = self.loss(view_sel, ray_idx, self.progress, draws)
        with tracing.span("step.backward"):
            grads = torch.autograd.grad(loss,
                                        [self.params[k] for k in names],
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(self.params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        with torch.no_grad(), tracing.span("step.adam"):
            self.opt_state = adam_update_(grads, self.opt_state, self.params,
                                          self.lrs(), b2=0.999)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    def run(self, max_iter: Optional[int] = None, log_every: int = 100,
            callback=None, on_step=None, stats: bool = False):
        """Train up to max_iter (Trainer.run's contract).  Metrics stay on
        the device between log points; at a log point the step's metrics
        are read, the loss checked for finiteness and ``callback(trainer,
        metrics)`` called with them as floats.  ``on_step`` runs twice per
        iteration: ``on_step(trainer, metrics)`` after the step, with its
        metrics as 0-d device tensors, and ``on_step(trainer, None)`` after
        it (BARF has no schedule update between them).  ``stats`` adds
        nothing: every sample is shaded, so there are no sample
        fractions."""
        end = self.max_iter if max_iter is None else max_iter
        t0 = time.time()
        while self.it < end:
            m = self.train_iteration()
            if on_step:
                on_step(self, m)
                on_step(self, None)
            if self.it % log_every == 0:
                mm = {k: float(v) for k, v in m.items()}
                # NaN/Inf guard (reference base.py:183-184), at log points
                if not math.isfinite(mm.get("loss", 0.0)):
                    raise FloatingPointError(
                        f"non-finite loss {mm['loss']} at it {self.it}")
                mm.update(it=self.it, wall=time.time() - t0)
                self.metrics_history.append(mm)
                if callback:
                    callback(self, mm)
            self.it += 1
        return self.metrics_history

    # -------------------------------------------------------------- eval
    def get_all_training_poses(self):
        pose = self.pose_base
        if self.is_barf:
            refine = lie.se3_to_SE3(self.params["se3_refine"].detach())
            pose = pose_ops.compose([refine, pose])
        return pose, self.gt_poses

    @torch.no_grad()
    def pose_error(self) -> dict:
        pose, gt = self.get_all_training_poses()
        aligned, _ = align_lib.prealign_cameras(pose, gt)
        r, t = align_lib.evaluate_camera_alignment(aligned, gt)
        return {"rot_deg": float(torch.rad2deg(torch.mean(r))),
                "trans": float(torch.mean(t))}

    @torch.no_grad()
    def render_views(self, pose, intr, intr_inv, chunk: int = 2048,
                     on_chunk=None):
        """Whole views of ``pose`` [B, 3, 4] in chunks of ``chunk`` rays
        (the last one padded with zero rays, as JAX pads it), unstratified,
        without noise, at progress 1 -> (rgb [B, HW, 3], depth, opacity
        [B, HW]).  ``on_chunk(i)`` runs after chunk i."""
        dev = self.device
        pose = torch.as_tensor(pose, device=dev)
        B = pose.shape[0]
        centers, dirs = get_center_and_ray(
            self.H, self.W, pose, torch.as_tensor(intr_inv, device=dev))
        if self.ndc:
            centers, dirs = convert_ndc(centers, dirs,
                                        torch.as_tensor(intr, device=dev))
        c = centers.reshape(-1, 3)
        d = dirs.reshape(-1, 3)
        n = c.shape[0]
        pad = (-n) % chunk
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad))
        outs = []
        for i, s in enumerate(range(0, n + pad, chunk)):
            rgb, rgb_f, depth, opac = self._render(c[s:s + chunk],
                                                   d[s:s + chunk], 1.0, {})
            outs.append((rgb if rgb_f is None else rgb_f, depth, opac))
            if on_chunk:
                on_chunk(i)
        rgb, depth, opac = (torch.cat(o)[:n] for o in zip(*outs))
        return rgb.reshape(B, -1, 3), depth.reshape(B, -1), opac.reshape(B, -1)

    def validate(self, data: Optional[SceneData] = None, align: bool = True,
                 on_chunk=None):
        """Mean PSNR over a split, its poses sim(3)-aligned into the
        learned frame first with BARF -> {"psnr", "rgb", "depth"}."""
        data = data or self.val_data
        if data is None:
            raise ValueError("validate: no split given and no val_data")
        pose = torch.as_tensor(data.poses, device=self.device)
        if self.is_barf and align:
            tr_pose, tr_gt = self.get_all_training_poses()
            _, sim3 = align_lib.prealign_cameras(tr_pose, tr_gt)
            pose = align_lib.align_test_pose(pose, sim3)
        rgb, depth, _ = self.render_views(pose, data.intr, data.intr_inv,
                                          on_chunk=on_chunk)
        target = torch.as_tensor(data.images, device=self.device).reshape(
            data.n_views, 3, -1).transpose(1, 2)
        mse_per = torch.mean((rgb - target) ** 2, dim=(1, 2))
        return {"psnr": float(torch.mean(-10 * torch.log10(mse_per))),
                "rgb": rgb, "depth": depth}
