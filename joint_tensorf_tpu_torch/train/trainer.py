"""Host-side training orchestrator
(counterpart of joint_tensorf_tpu/train/trainer.py).

Runs BAT's whole schedule: the 2D supervision blur cache with its hard edge
masks, the random 2D/3D blur scales, the ray grid, the learning-rate and
pose-lr schedules, the train step, and after the scheduled iterations the
phase transitions of the JAX trainer's _update_schedule /
_update_alphamask: voxel upsample with a fresh optimiser and the lr reset,
the alpha-mask build (at a capped resolution past tpu.mask_cap_voxels),
and the bbox shrink at the first, uncapped mask update.

The step is the JAX trainer's default ``tpu:`` path (_step_config): the
sample-compaction budgets (in-bbox, _refresh_bbox_k; the dilated mask
under the blur, _refresh_blur_mask; the alpha mask, _probe_compact_k),
the dense-grid density while the blur is on or no mask is built, and the
two-stage appearance with its auto-raised cap (_probe_app_k).  A failed
probe raises: the JAX trainer's "never block training" fallbacks are not
copied.

All schedule randomness comes from one numpy generator, drawn in the JAX
trainer's order (the probes at a mask update included), so both trainers
see the same ray indices and blur scales; device randomness (pose noise,
field init, stratified jitter) comes from a torch.Generator.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..data.base import SceneData
from ..geometry import lie, poses as pose_ops
from ..models import alpha_mask as am_lib
from ..models import vm as vm_lib
from ..ops import blur as blur_ops
from ..ops import kernels as kernel_ops
from ..ops import sobel
from ..geometry.rays import get_center_and_ray
from ..ops.composite import transmittance
from ..render.renderer import BlurSpec, sample_ray_axes, step_size
from ..sched import schedules
from ..utils.torch_setup import resolve_device, setup_torch
from .step import (StepConfig, StepScalars, compose_train_pose,
                   init_train_state, rebuild_opt_state, train_step)

# (dotted key, the value or values the port runs); others raise.  None,
# False and 0 all mean "off".
_PORTED_VALUES = (
    ("model", "bat"),
    ("camera.ndc", False),
    ("tpu.mesh_shape", None),
    ("tpu.factor_dtype", "float32"),
    ("tpu.densify_impl", ("packed8", "lane")),
    ("tpu.plane_scatter", ("xla", "segsum", "runsum")),
    ("tpu.eval_app_k", None),
    ("arch.tensorf.model", ("BAT_VMSplit", "TensorVMSplit")),
    ("arch.shading.model", "MLP_Fea"),
    ("arch.shading.predict_density", False),
    ("arch.shading.detach_viewdirs", True),
    ("arch.feature_to_density_activation", "softplus"),
    ("arch.abs_components", False),
    ("arch.component_wise_feature2density", False),
    ("arch.plane_feature2density", False),
    ("arch.convolve_plane_only", False),
    ("arch.convolve_positive_only", False),
    ("arch.ignore_negative_split", False),
    ("nerf.setbg_opaque", True),
    ("nerf.sample_stratified", True),
    ("nerf.ray_sampling_strategy", "all_view_rand_grid"),
    ("train_schedule.all_view_sample_after_n_iters", None),
    ("train_schedule.single_view_sample_after_n_iters", None),
    ("train_schedule.reset_pose_on_iter", None),
    ("train_schedule.reset_pose_on_iters", None),
    ("train_schedule.reset_pose_on_first_upsample", None),
    ("train_schedule.pin_first_pose", False),
    ("optim.sched_pose.type", "ExponentialLR"),
    ("optim.warmup_pose", None),
    ("loss_weight.TV_density", 0.0),
    ("loss_weight.TV_color", 0.0),
    ("soft_edge_mask", False),
    ("sync_2d_3d_scales", None),
)

# The tpu: keys.  Those in _PORTED_VALUES run only at the values named
# there: tpu.densify_impl packed8 and lane are one sampler here
# (ops/densify.py); tpu.plane_scatter's xla / segsum / runsum compute one
# function, which K3 computes; tpu.eval_app_k belongs to evaluation, a
# later slice.  tpu.densify_dtype is checked with the layout
# (_DENSIFY_DTYPES): the JAX renderer reads it only under densify_impl
# lane (its bf16 row gather, not ported) and computes float32 under
# packed8 whatever it says, as the port does.  The others run at any
# value: tpu.mesh_axes matters only with a mesh, tpu.donate_state is an
# XLA buffer choice with no counterpart.  A tpu: key in none of these
# raises.
_DENSIFY_DTYPES = {"packed8": ("float32", "bfloat16"), "lane": ("float32",)}
_TPU_ANY_VALUE = (
    "mesh_axes", "donate_state", "densify_density", "bbox_compact",
    "blur_mask_compact", "blur_mask_refresh", "mask_res_cap",
    "mask_cap_voxels", "densify_min_samples_per_chip", "app_k",
    "app_k_auto", "app_k_max", "app_k_dense_only", "mask_stride")


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (a later slice "
                               f"of the PyTorch port)")


def _off(v) -> bool:
    return v is None or v is False or (isinstance(v, (int, float)) and v == 0)


def check_ported(opt: Options):
    """Raise NotImplementedError naming the first option whose value the
    port does not run, or a tpu: key it does not know."""
    for key, want in _PORTED_VALUES:
        got = opt.get_path(key)
        ok = (_off(got) if _off(want)
              else got in want if isinstance(want, tuple) else got == want)
        if not ok:
            raise _unported(f"option {key}={got!r}")
    impl = opt.get_path("tpu.densify_impl")
    dtype = opt.get_path("tpu.densify_dtype") or "float32"
    if dtype not in _DENSIFY_DTYPES[impl]:
        raise _unported(f"option tpu.densify_dtype={dtype!r} under "
                        f"tpu.densify_impl={impl!r}")
    checked = {k[4:] for k, _ in _PORTED_VALUES if k.startswith("tpu.")}
    checked.add("densify_dtype")
    for key in opt.get("tpu") or {}:
        if key not in checked and key not in _TPU_ANY_VALUE:
            raise _unported(f"option tpu.{key}")
    # re-initialising factors at the last upsample needs init_vm(prev=...)
    reset = opt.get_path("train_schedule.reset_on_last_upsample")
    if reset and any(reset.get(k) for k in ("density", "appearance",
                                            "basis")):
        raise _unported(f"option train_schedule.reset_on_last_upsample="
                        f"{dict(reset)!r}")


def build_vm_config(opt: Options) -> vm_lib.VMConfig:
    arch = opt.arch
    return vm_lib.VMConfig(
        density_n_comp=tuple(int(c) for c in arch.tensorf.density_components),
        app_n_comp=tuple(int(c) for c in arch.tensorf.color_components),
        app_dim=int(arch.shading.app_dim),
        view_pe=int(arch.shading.view_pe),
        fea_pe=int(arch.shading.fea_pe),
        hidden=int(arch.shading.mlp_hidden_dim),
        density_shift=float(arch.density_shift),
        distance_scale=float(arch.distance_scale),
        raymarch_weight_thres=float(arch.tensorf.rayMarch_weight_thres),
        step_ratio=float(opt.nerf.step_ratio),
    )


class Trainer:
    """Joint pose + tensorial-field training (BAT)."""

    def __init__(self, opt: Options, train_data: SceneData, device=None):
        check_ported(opt)
        setup_torch()
        self.opt = opt
        self.device = dev = resolve_device(device)
        self.it = 0
        self.max_iter = int(opt.max_iter)
        seed = int(opt.get("seed", 0))
        self.rng_np = np.random.default_rng(seed)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.vm_cfg = build_vm_config(opt)

        # ---------------- scene geometry / voxel schedule
        ts = opt.train_schedule
        self.bbox = np.asarray(opt.data.scene_bbox,
                               dtype=np.float32).reshape(2, 3)
        self.upsample_iters = list(ts.upsample_iters)
        self.update_alphamask_iters = list(ts.update_alphamask_iters)
        self.n_voxel_list = schedules.voxel_schedule(
            int(ts.n_voxel_init), int(ts.n_voxel_final),
            len(self.upsample_iters))
        self.n_voxels = int(ts.n_voxel_init)
        self.resolution_scale = list(ts.get("resolution_scale_init",
                                            [1.0] * 3))
        self.resolution = schedules.find_resolution(
            self.bbox, self.n_voxels, self.resolution_scale)
        self.n_samples = schedules.find_n_samples(
            self.resolution, float(opt.nerf.step_ratio),
            int(opt.nerf.sample_intvs))

        # ---------------- alpha mask
        self.alpha_mask: Optional[am_lib.AlphaMask] = None
        self.alphamask_resolution = list(self.resolution)
        self.alphamask_thresh = float(ts.get("alpha_mask_threshold", 1e-4))
        self.mask_stride = int(opt.tpu.get("mask_stride", 4))

        # ---------------- learning rates / decay
        o = opt.optim
        self.lr_index0 = float(o.lr_index)
        self.lr_basis0 = float(o.lr_basis)
        self.lr_index = self.lr_index0
        self.lr_basis = self.lr_basis0
        decay_iters = int(o.get("lr_decay_iters", -1))
        duration = self.max_iter if decay_iters < 0 else decay_iters
        self.lr_decay_target = float(o.get("lr_decay_target_ratio", 0.1))
        self.decay_factor = schedules.lr_decay_factor(self.lr_decay_target,
                                                      duration)
        self.lr_upsample_reset = bool(o.get("lr_upsample_reset", True))
        self.lr_pose0 = float(o.get("lr_pose", 0.0) or 0.0)
        self.pose_gamma = ((float(o.lr_pose_end) / self.lr_pose0) ** (
            1.0 / self.max_iter) if self.lr_pose0 > 0 else 1.0)

        # ---------------- pose noise: base = GT o noise
        V, H, W = train_data.n_views, train_data.H, train_data.W
        self.n_views, self.H, self.W = V, H, W
        self.gt_poses = torch.as_tensor(train_data.poses, device=dev)
        if opt.camera.get("noise"):
            se3_noise = torch.randn((V, 6), generator=self.generator,
                                    device=dev) * float(opt.camera.noise)
            self.pose_base = pose_ops.compose([lie.se3_to_SE3(se3_noise),
                                               self.gt_poses])
        else:
            self.pose_base = self.gt_poses

        # ---------------- device-side dataset
        self.images_chw = torch.as_tensor(train_data.images, device=dev)
        self.images_sharp = self.images_chw.reshape(V, 3, H * W).transpose(
            1, 2).contiguous()                                   # [V,HW,3]
        self.intr_inv = torch.as_tensor(train_data.intr_inv, device=dev)
        self.near_far = list(train_data.near_far)

        self.blur_2d = bool(opt.get("blur_2d", False))
        self.scale_pool_2d = list(opt.get("c2f_alternate_2D_scale_pool",
                                          [0.0, 1.0]))
        self.blurred_images = {0.0: self.images_sharp}
        self.edge_masks = {0.0: torch.zeros((V, H * W), device=dev)}
        self.current_images = self.images_sharp
        self.current_edges = self.edge_masks[0.0]
        self._blur_cache_at = None

        # ---------------- field + optimizer
        field = vm_lib.init_vm(
            self.vm_cfg, self.resolution, self.bbox, self.generator,
            init_scale=float(opt.arch.tensorf.get("volume_init_scale", 0.1)),
            init_bias=float(opt.arch.tensorf.get("volume_init_bias", 0.0)),
            device=dev)
        self.state = init_train_state(field, V)
        self.metrics_history: list[dict] = []

        # ---------------- sample-compaction budgets (None: all S slots)
        self.compact_k: Optional[int] = None        # under the alpha mask
        self.app_k_dyn: Optional[int] = None        # raised tpu.app_k
        self.compact_k_bbox: Optional[int] = None   # in-bbox gate alone
        self.alpha_mask_blur: Optional[am_lib.AlphaMask] = None
        self.compact_k_blur: Optional[int] = None   # dilated mask, blur on
        self._blur_mask_built_at: Optional[int] = None
        self.last_step_config: Optional[StepConfig] = None
        self._refresh_bbox_k()

    # ------------------------------------------------------------- schedules
    @property
    def progress(self) -> float:
        return self.it / self.max_iter

    def _n_rays(self) -> int:
        ts = self.opt.train_schedule
        if ts.get("change_n_rays_after_n_iters") is not None:
            if self.it < ts.change_n_rays_after_n_iters:
                return int(ts.n_rays_init)
            return int(ts.n_rays_rest)
        return int(self.opt.nerf.n_rays)

    def _pose_accum(self) -> int:
        ts = self.opt.train_schedule
        if ts.get("change_AccumPoseGrad_after_n_iters") is not None:
            if self.it < ts.change_AccumPoseGrad_after_n_iters:
                return int(ts.n_AccumPoseGrad_init)
            return int(ts.n_AccumPoseGrad_rest)
        return int(self.opt.optim.get("pose_grad_accum_iter", 1))

    def _blur_spec(self, c2f_d: float, c2f_c: float) -> Optional[BlurSpec]:
        opt = self.opt
        # no blur without a mode, or below the kernel-drop epsilon
        if opt.get("c2f_mode", "None") in (None, "None") or \
                max(c2f_d, c2f_c) < 1e-3:
            return None
        return BlurSpec(mode=opt.c2f_mode, kernel_size=int(opt.c2f_kernel_size))

    def _c2f_params(self):
        """(c2f_density, c2f_color, scale_2d) for this iteration; draws the
        2D scale, then the density scale, from rng_np."""
        opt = self.opt
        if opt.get("c2f_mode", "None") in (None, "None"):
            return 0.0, 0.0, 0.0
        d = schedules.interp_schedule(self.progress, opt.c2f_schedule_density)
        c = schedules.interp_schedule(self.progress, opt.c2f_schedule_color)
        sc2d = 0.0
        if self.blur_2d and opt.get("c2f_alternate_2D_blur"):
            sc2d = float(self.rng_np.choice(self.scale_pool_2d))
        if opt.get("c2f_random_density_blur"):
            d = d * float(self.rng_np.choice(
                opt.c2f_random_density_scale_pool))
        return float(d), float(c), sc2d

    def _near_far(self):
        opt = self.opt
        if opt.data.dataset != "blender" and \
                opt.get("tensorf_near_plane_schedule") is not None:
            near = schedules.interp_schedule(
                self.progress, opt.tensorf_near_plane_schedule)
            return [float(near), self.near_far[1]]
        return self.near_far

    def _lr_pose(self) -> float:
        return float(self.lr_pose0 * self.pose_gamma ** self.it)

    def _l1_weight(self) -> float:
        lw = self.opt.loss_weight.get("L1")
        if lw is None:
            return 0.0
        first_update = self.update_alphamask_iters[0] \
            if self.update_alphamask_iters else self.max_iter
        return float(lw.rest if self.it > first_update else lw.init)

    def _edge_scalars(self):
        opt = self.opt
        use = 0.0
        if opt.get("edge_mask_on_render_loss") and self.blur_2d:
            on = (self.it % 2 == 0) if opt.get("alternate_edge_loss") else True
            if on and self.it < int(opt.get("edge_mask_before_iter", 0)):
                use = 1.0
        return (use, float(opt.get("edge_loss_factor", 1.5)),
                float(opt.get("non_edge_loss_factor", 0.5)))

    def _tv_depth_weight(self) -> float:
        lw = self.opt.loss_weight
        if lw.get("TV_depth") is None:
            return 0.0
        until = lw.get("TV_depth_until_iters")
        if until is not None and self.it > int(until):
            return 0.0
        return float(lw.TV_depth)

    # ------------------------------------------------------ 2D blur pipeline
    @torch.no_grad()
    def _refresh_blur_cache(self):
        """Blur the GT images and build the hard edge masks for every scale
        in the pool (runs every 500 iterations)."""
        opt = self.opt
        V, H, W = self.n_views, self.H, self.W
        sched_val = schedules.interp_schedule(self.progress,
                                              opt.blur_2d_c2f_schedule)
        ksize = int(opt.blur_2d_c2f_kernel_size)
        thresh = float(opt.get("hard_edge_mask_mean_thresh", 1.25))
        self.blurred_images, self.edge_masks = {}, {}
        for sc in self.scale_pool_2d:
            width = sched_val * sc * (W + H) / 2
            if width < 0.01:
                imgs_chw = self.images_chw
                imgs_flat = self.images_sharp
            else:
                if opt.get("blur_2d_mode",
                           "uniform-gaussian") == "uniform-gaussian":
                    k = kernel_ops.gaussian_kernel(width, ksize,
                                                   device=self.device)
                else:
                    k = kernel_ops.average_kernel(width, ksize,
                                                  device=self.device)
                imgs_chw = blur_ops.blur_images_hw(
                    self.images_chw, blur_ops.blur_matrix(k, H),
                    blur_ops.blur_matrix(k, W))
                imgs_flat = imgs_chw.reshape(V, 3, H * W).transpose(
                    1, 2).contiguous()
            self.blurred_images[sc] = imgs_flat
            self.edge_masks[sc] = sobel.hard_edge_mask(
                imgs_chw, thresh).to(torch.float32)

    # -------------------------------------------------------- ray sampling
    def _sample_rays(self, n_rays: int):
        """all_view_rand_grid: a regular pixel grid with a random offset,
        the same for every view -> (view_sel [V], ray_idx [R], (ny, nx))."""
        V, H, W = self.n_views, self.H, self.W
        rays_per_view = max(1, n_rays // V)
        step = math.ceil((H * W / rays_per_view) ** 0.5)
        off_x = int(self.rng_np.integers(step))
        off_y = int(self.rng_np.integers(step))
        # static grid: positions wrap modulo the image extent
        nx = math.ceil(W / step)
        ny = math.ceil(H / step)
        xs = (off_x + step * np.arange(nx)) % W
        ys = (off_y + step * np.arange(ny)) % H
        gx, gy = np.meshgrid(xs, ys)
        idx = (gx + gy * W).reshape(-1)
        return np.arange(V), idx.astype(np.int64), (ny, nx)

    # ------------------------------------------------------------- main loop
    def host_schedule(self):
        """This iteration's host-side inputs, drawing rng_np in the JAX
        trainer's order: (scalars, blur spec, view_sel, ray_idx, grid_hw,
        2D scale)."""
        opt = self.opt
        it = self.it
        if self.blur_2d and self._blur_cache_at != (it // 500) * 500:
            self._refresh_blur_cache()
            self._blur_cache_at = (it // 500) * 500

        c2f_d, c2f_c, sc2d = self._c2f_params()
        blur_spec = self._blur_spec(c2f_d, c2f_c)
        use_edge, ef, nef = self._edge_scalars()
        view_sel, ray_idx, grid_hw = self._sample_rays(self._n_rays())
        vp = fp = 1.0
        if opt.get("c2f_view_pe_schedule") is not None:
            vp = schedules.interp_schedule(self.progress,
                                           opt.c2f_view_pe_schedule)
        if opt.get("c2f_fea_pe_schedule") is not None:
            fp = schedules.interp_schedule(self.progress,
                                           opt.c2f_fea_pe_schedule)
        scalars = StepScalars(
            lr_index=self.lr_index, lr_basis=self.lr_basis,
            lr_pose=self._lr_pose(), c2f_density=c2f_d, c2f_color=c2f_c,
            near_far=tuple(self._near_far()), l1_weight=self._l1_weight(),
            use_edge=use_edge, edge_factor=ef, non_edge_factor=nef,
            view_pe_progress=float(vp), fea_pe_progress=float(fp),
            pose_do_step=1.0 if it % self._pose_accum() == 0 else 0.0,
            tv_depth_weight=self._tv_depth_weight())
        return scalars, blur_spec, view_sel, ray_idx, grid_hw, sc2d

    def train_iteration(self, stats: bool = False, jitter=None):
        """One step; ``stats`` adds the step's sample fractions and blur
        flag to its metrics (train_step); ``jitter`` [rays, 1]: pre-drawn
        stratified offsets (else drawn from the trainer's generator)."""
        scalars, blur_spec, view_sel, ray_idx, grid_hw, sc2d = \
            self.host_schedule()
        if blur_spec is not None:
            self._refresh_blur_mask()
        if self.blur_2d:
            self.current_images = self.blurred_images[sc2d]
            edge_scale = float(self.opt.get("edge_mask_use_scale", sc2d))
            self.current_edges = self.edge_masks.get(edge_scale,
                                                     self.edge_masks[sc2d])
        cfg = self._step_config(len(ray_idx), blur_spec, grid_hw)
        self.rays_per_step = len(view_sel) * len(ray_idx)
        self.last_step_config = cfg
        metrics, _ = train_step(
            self.state, cfg, self.vm_cfg, self.pose_base, self.intr_inv,
            self.current_images, self.current_edges,
            torch.as_tensor(view_sel, device=self.device),
            torch.as_tensor(ray_idx, device=self.device), scalars,
            generator=self.generator, jitter=jitter,
            alpha_mask=self._step_mask(blur_spec is not None), stats=stats)
        return metrics

    def _step_mask(self, blur_active: bool) -> Optional[am_lib.AlphaMask]:
        """The mask that gates the step's samples: the JAX trainer's step
        mask with its use_alpha_mask / mask_with_blur gate applied.  Under
        the blur, the dilated mask while it has a budget (else none: the
        sharp mask would cull what the blur spreads); without it, the alpha
        mask once built."""
        return self.alpha_mask_blur if blur_active else self.alpha_mask

    def _samples_per_step(self, rays_per_view: int) -> int:
        """Density samples per step: the dense-grid gate's measure (the
        JAX trainer's _samples_per_chip on one chip)."""
        return rays_per_view * self.n_views * self.n_samples

    def _step_config(self, rays_per_view: int, blur: Optional[BlurSpec],
                     grid_hw) -> StepConfig:
        """The JAX trainer's _ensure_step choice (trainer.py:576-650):
        under the blur, compact on the dilated mask's budget when there is
        one, else on the in-bbox budget; without the blur, on the alpha
        mask's budget once a mask is built.  The dense grid runs while the
        blur is on or no mask is built, and only past
        tpu.densify_min_samples_per_chip samples per step."""
        tpu = self.opt.tpu
        blur_active = blur is not None
        app_k = (self.app_k_dyn if self.app_k_dyn is not None
                 else (int(tpu.app_k) if tpu.get("app_k") else None))
        if (not blur_active) and self.compact_k is not None and \
                bool(tpu.get("app_k_dense_only", False)):
            app_k = None
        if blur_active and self.compact_k_blur is not None:
            compact_k = self.compact_k_blur
        elif blur_active or self.compact_k is None:
            compact_k = self.compact_k_bbox
        else:
            compact_k = self.compact_k
        densify = (bool(tpu.get("densify_density", True))
                   and (blur_active or self.compact_k is None)
                   and self._samples_per_step(rays_per_view) >= int(
                       tpu.get("densify_min_samples_per_chip", 100000)))
        return StepConfig(
            H=self.H, W=self.W, n_views=self.n_views,
            rays_per_view=rays_per_view, n_samples=self.n_samples,
            blur=blur, grid_hw=grid_hw, mask_stride=self.mask_stride,
            compact_k=compact_k, densify_density=densify, app_k=app_k)

    # ------------------------------------------------------ phase transitions
    def _replace_field(self, make_field):
        """Swap in ``make_field(old field)`` with fresh Adam moments; the
        old moments are freed before the new field is built, the old field
        before the new moments."""
        self.state.scene_opt = None
        self.state.field = make_field(self.state.field)
        self.state = rebuild_opt_state(self.state)
        self.resolution = self.state.field.resolution()
        self.n_samples = schedules.find_n_samples(
            self.resolution, float(self.opt.nerf.step_ratio),
            int(self.opt.nerf.sample_intvs))

    def _field_aabb_np(self) -> np.ndarray:
        return self.state.field.aabb.cpu().numpy()

    def _update_schedule(self):
        """Post-iteration schedule updates (the JAX trainer's
        _update_schedule, joint_tensorf_tpu/train/trainer.py:795-842)."""
        it = self.it
        if it in self.upsample_iters:
            if it == self.upsample_iters[0]:
                self.resolution_scale = [1.0, 1.0, 1.0]
            self.n_voxels = self.n_voxel_list.pop(0)
            res = schedules.find_resolution(self._field_aabb_np(),
                                            self.n_voxels,
                                            self.resolution_scale)
            self._replace_field(lambda f: vm_lib.upsample(f, res))
            self._refresh_bbox_k()
            # lr reset instead of this iteration's decay
            scale = 1.0 if self.lr_upsample_reset else (
                self.lr_decay_target ** (it / self.max_iter))
            self.lr_index = self.lr_index0 * scale
            self.lr_basis = self.lr_basis0 * scale
        else:
            self.lr_index *= self.decay_factor
            self.lr_basis *= self.decay_factor
        if it in self.update_alphamask_iters:
            self._update_alphamask(it)

    def _update_alphamask(self, it: int):
        """The JAX trainer's _update_alphamask (trainer.py:844-889): build
        the mask, at capped_mask_res past tpu.mask_cap_voxels (or not at all
        when tpu.mask_res_cap is off), and shrink the box at the first
        update when the mask is uncapped."""
        opt = self.opt
        res = self.resolution
        cap = int(opt.tpu.get("mask_cap_voxels", 256 ** 3))
        capped = res[0] * res[1] * res[2] >= cap
        if capped and not bool(opt.tpu.get("mask_res_cap", True)):
            return
        self.alphamask_resolution = (am_lib.capped_mask_res(res, cap)
                                     if capped else list(res))
        step = schedules.step_size(self._field_aabb_np(), res,
                                   float(opt.nerf.step_ratio))
        self.alpha_mask, new_aabb = am_lib.update_alpha_mask(
            self.state.field, self.vm_cfg, self.alphamask_resolution, step,
            self.alphamask_thresh)
        # both probes draw their rays from the training generator
        self.compact_k = self._probe_compact_k()
        self.app_k_dyn = self._probe_app_k()
        if not capped and it == self.update_alphamask_iters[0] and \
                opt.train_schedule.get("shrink_bbox_with_alphamask", True):
            self._replace_field(lambda f: vm_lib.shrink(f, new_aabb))
            self._refresh_bbox_k()

    # ------------------------------------------------ compaction budgets
    def get_all_training_poses(self):
        """(poses [V,3,4], GT poses): the learned refinement composed on
        GT o noise for every view."""
        views = torch.arange(self.n_views, device=self.device)
        pose = compose_train_pose(self.state.se3_refine.detach(),
                                  self.pose_base, views)
        return pose, self.gt_poses

    def _probe_rays(self, rng: np.random.Generator, n_probe_rays: int):
        """(centers, dirs) [n, 3] of every view's first n_probe_rays / V
        pixels of a permutation drawn from ``rng``."""
        poses, _ = self.get_all_training_poses()
        per_view = max(1, n_probe_rays // self.n_views)
        idx = torch.as_tensor(rng.permutation(self.H * self.W)[:per_view],
                              device=self.device)
        centers, dirs = get_center_and_ray(self.H, self.W, poses,
                                           self.intr_inv, ray_idx=idx)
        return centers.reshape(-1, 3), dirs.reshape(-1, 3)

    @torch.no_grad()
    def _probe_compact_k(self, n_probe_rays: int = 4096, pad: float = 1.25,
                         bbox_only: bool = False,
                         mask: Optional[am_lib.AlphaMask] = None):
        """The compaction budget K (trainer.py:891-1004): the most live
        sample slots of any probe ray, counted as the renderer selects
        them (live probe groups x stride: alpha probed at each group's
        first sample, and any of its samples in the box), times ``pad``,
        rounded up to a multiple of 128 (at least 128); None when K would
        reach S.  ``bbox_only`` counts the in-bbox gate alone.  The probe
        rays come from the training generator for the alpha mask's probe,
        and from a generator of their own (seed + 12345) for the in-bbox
        and blur-mask probes, which must not move the training draws."""
        probe_mask = mask if mask is not None else self.alpha_mask
        if probe_mask is None and not bbox_only:
            return None
        rng = self.rng_np
        if bbox_only or mask is not None:
            rng = np.random.default_rng(int(self.opt.get("seed", 0)) + 12345)
        centers, dirs = self._probe_rays(rng, n_probe_rays)
        S = self.n_samples
        g = self.mask_stride if (self.mask_stride > 1
                                 and S % self.mask_stride == 0) else 1
        aabb = self.state.field.aabb
        axes_w, _, in_bbox, _ = sample_ray_axes(
            aabb, step_size(aabb, self.resolution, self.vm_cfg.step_ratio),
            S, centers, dirs, self.near_far[0], self.near_far[1], False)
        n = centers.shape[0]
        alive = in_bbox.reshape(n, S // g, g).any(dim=-1)
        if not bbox_only:
            first = tuple(w[:, ::g].reshape(-1) for w in axes_w)
            alive &= am_lib.sample_alpha(probe_mask, first).reshape(
                n, S // g) > 0
        mx = int(alive.sum(dim=-1).max()) * g
        k = min(S, max(128, int(-(-int(mx * pad) // 128) * 128)))
        return None if k >= S else k

    @torch.no_grad()
    def _probe_app_k(self, n_probe_rays: int = 4096,
                     quantile: float = 0.98) -> Optional[int]:
        """The raised two-stage appearance cap (trainer.py:1006-1093): the
        ``quantile`` of the per-ray count of samples past the weight gate
        (mask and box applied, unblurred density), rounded up to a multiple
        of 64, clamped to [tpu.app_k, tpu.app_k_max]; None (keep tpu.app_k)
        when it would not rise, when no probe ray clips at tpu.app_k, or
        with tpu.app_k_auto off.  Draws its probe rays from the training
        generator."""
        tpu = self.opt.tpu
        base = int(tpu.app_k) if tpu.get("app_k") else None
        if base is None or not bool(tpu.get("app_k_auto", True)):
            return None
        centers, dirs = self._probe_rays(self.rng_np, n_probe_rays)
        S = self.n_samples
        field = self.state.field
        near, far = self._near_far()
        axes_w, z_vals, valid, _ = sample_ray_axes(
            field.aabb, step_size(field.aabb, self.resolution,
                                  self.vm_cfg.step_ratio),
            S, centers, dirs, near, far, False)
        n = centers.shape[0]
        flat = tuple(w.reshape(-1) for w in axes_w)
        if self.alpha_mask is not None:
            valid = valid & (am_lib.sample_alpha(self.alpha_mask, flat)
                             .reshape(n, S) > 0)
        coords = tuple(vm_lib.normalize_coord(w, field.aabb[:, a])
                       for a, w in enumerate(flat))
        sigma = vm_lib.feature2density(
            self.vm_cfg, vm_lib.compute_density_feature(field, coords)
        ).reshape(n, S)
        sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                           torch.zeros_like(z_vals[:, :1])], -1)
        _, _, weight = transmittance(
            1.0 - torch.exp(-sigma * dists * self.vm_cfg.distance_scale))
        n_gate = ((weight > self.vm_cfg.raymarch_weight_thres) & valid).sum(
            dim=-1).cpu().numpy()
        k_q = int(np.quantile(n_gate, quantile))
        clip = float((n_gate > base).mean())
        k = min(max(base, int(-(-k_q // 64) * 64)),
                int(tpu.get("app_k_max", 256)))
        if (k > base and clip == 0.0) or S <= base:
            k = base
        if k != base:
            print(f"[app_k] gate quantile({quantile})={k_q} clips "
                  f"{clip:.1%} of rays at app_k={base} -> raising to {k}",
                  flush=True)
        return None if k == base else k

    def _refresh_bbox_k(self):
        """After a shape change: the in-bbox budget anew (pad 1.0: the
        in-bbox count is camera and box geometry), the blur mask dropped."""
        self.alpha_mask_blur = None
        self.compact_k_blur = None
        self._blur_mask_built_at = None
        self.compact_k_bbox = (
            self._probe_compact_k(bbox_only=True, pad=1.0)
            if bool(self.opt.tpu.get("bbox_compact", True)) else None)

    def _blur_sigma_max(self, lookahead_iters: int) -> float:
        """The largest world sigma of the density blur over the next
        ``lookahead_iters`` iterations: the piecewise-linear schedule at
        both ends and at every knot between, times the largest random
        scale (trainer.py:260-281)."""
        opt = self.opt
        p0 = self.progress
        p1 = min(1.0, (self.it + lookahead_iters) / self.max_iter)
        sched = list(opt.c2f_schedule_density)
        knots = np.linspace(0.0, 1.0, len(sched))
        pts = [p0, p1] + [float(k) for k in knots if p0 < k < p1]
        d = max(float(schedules.interp_schedule(p, sched)) for p in pts)
        if opt.get("c2f_random_density_blur"):
            d *= max(float(s) for s in opt.c2f_random_density_scale_pool)
        return d

    def _blur_dilate_radius(self, lookahead_iters: int, mask_res) -> int:
        """Mask cells that cover the blur kernel's support
        (trainer.py:283-312): 5 sigma (Gaussian) or sigma (average) in mask
        cells, rounded up, plus one, at most the kernel's half width."""
        opt = self.opt
        smax = self._blur_sigma_max(lookahead_iters)
        aabb = self._field_aabb_np().astype(np.float64)
        size = aabb[1] - aabb[0]
        grid_scale = float(np.mean(np.asarray(self.resolution, np.float64)
                                   / size))
        mask_scale = float(np.mean(np.asarray(mask_res, np.float64) / size))
        sig_mask = smax * mask_scale
        if str(opt.get("c2f_mode", "uniform-gaussian")) == "uniform-average":
            r = int(np.ceil(sig_mask)) + 1
        else:
            r = int(np.ceil(5.0 * sig_mask)) + 1
        halfw_mask = int(np.ceil((int(opt.c2f_kernel_size) // 2)
                                 * mask_scale / grid_scale))
        return max(1, min(halfw_mask, r))

    def _refresh_blur_mask(self):
        """The dilated-mask budget while the blur is on
        (trainer.py:314-382): once the resolution is final, every
        tpu.blur_mask_refresh iterations, build the sharp mask, dilate it
        by the blur's support over the window and probe its budget; None
        (the in-bbox budget stays) when it would keep every slot."""
        opt = self.opt
        if not bool(opt.tpu.get("blur_mask_compact", True)):
            return
        res = self.resolution
        cap = int(opt.tpu.get("mask_cap_voxels", 256 ** 3))
        capped = res[0] * res[1] * res[2] >= cap
        if capped and not bool(opt.tpu.get("mask_res_cap", True)):
            return
        if self.upsample_iters and self.it < self.upsample_iters[-1]:
            return
        refresh = int(opt.tpu.get("blur_mask_refresh", 1000))
        if self._blur_mask_built_at is not None and \
                self.it - self._blur_mask_built_at < refresh:
            return
        mask_res = am_lib.capped_mask_res(res, cap) if capped else list(res)
        radius = self._blur_dilate_radius(refresh, mask_res)
        step = schedules.step_size(self._field_aabb_np(), res,
                                   float(opt.nerf.step_ratio))
        mask, _ = am_lib.update_alpha_mask(self.state.field, self.vm_cfg,
                                           mask_res, step,
                                           self.alphamask_thresh)
        mask = am_lib.dilate_mask(mask, radius)
        k = self._probe_compact_k(mask=mask)
        self._blur_mask_built_at = self.it
        self.alpha_mask_blur = None if k is None else mask
        self.compact_k_blur = k
        if k is not None:
            print(f"[blur_mask] it {self.it}: dilation r={radius} cells -> "
                  f"compact_k_blur={k} of S={self.n_samples} "
                  f"(bbox budget {self.compact_k_bbox})", flush=True)

    def run(self, max_iter: Optional[int] = None, log_every: int = 100,
            callback=None, on_step=None, stats: bool = False):
        """Run the training loop up to max_iter.  Metrics stay on the device
        between log points; at a log point every pending iteration's
        metrics are checked for finiteness.  ``callback(trainer, metrics)``
        runs at each log point with the metrics as floats.  ``on_step`` runs
        twice per iteration: ``on_step(trainer, metrics)`` after the step,
        with its metrics as 0-d device tensors, and ``on_step(trainer,
        None)`` after the schedule update (the phase transitions).
        ``stats`` is passed to train_iteration."""
        end = self.max_iter if max_iter is None else max_iter
        t0 = time.time()
        pending: list[tuple[int, dict]] = []
        while self.it < end:
            metrics = self.train_iteration(stats)
            if on_step:
                on_step(self, metrics)
            self._update_schedule()
            if on_step:
                on_step(self, None)
            pending.append((self.it, metrics))
            if self.it % log_every == 0:
                for it_i, vals in pending:
                    for key, val in vals.items():
                        if not math.isfinite(float(val)):
                            raise FloatingPointError(
                                f"non-finite {key}={float(val)} at it {it_i} "
                                f"(detected at log point it {self.it})")
                m = {k: float(v) for k, v in pending[-1][1].items()}
                pending.clear()
                m.update(it=self.it, wall=time.time() - t0,
                         lr_index=self.lr_index, lr_pose=self._lr_pose())
                self.metrics_history.append(m)
                if callback:
                    callback(self, m)
            self.it += 1
        return self.metrics_history
