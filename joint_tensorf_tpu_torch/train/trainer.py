"""Host-side training orchestrator
(counterpart of joint_tensorf_tpu/train/trainer.py).

Runs BAT's whole schedule (and TensoRF's: BAT's without the pose table,
the blurs and the pose schedules; L2G-BAT's through train/l2g_trainer.py):
the 2D supervision blur cache with its hard (or soft) edge masks, the
random 2D/3D blur scales (drawn apart, or one for both with
sync_2d_3d_scales), the ray strategies (the grid, and all-view or
single-view random rays from their switch iterations), the learning-rate
and pose-lr schedules (with warmup_pose), the pose resets, the TV
weights' decay, the train step, and after the scheduled iterations the phase transitions of
the JAX trainer's _update_schedule / _update_alphamask: voxel upsample
with a fresh optimiser and the lr reset, the alpha-mask build (at a
capped resolution past tpu.mask_cap_voxels), the bbox shrink at the
first, uncapped mask update, and with train_schedule.reset_on_last_upsample
the groups it names re-drawn after the last upsample.

Under ``camera.ndc`` the rays are NDC rays; as in JAX no compaction budget
is probed and no blur mask built there, so the dense grid runs in every
phase with enough samples.

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

With ``tpu.mesh_shape`` (a ``rays`` axis and a ``comp`` axis, in either
order; parallel/) the trainer is one rank of a sharded run: it builds the
mesh (trainer.py:204-223 of the JAX package), every rank draws the whole
schedule (rng_np, the generator's jitter and coin), the step renders this
rank's block of the rays and reduces the gradients (train/step.py), the
dense-grid gate counts samples per rank of the rays axis
(_samples_per_chip), the rays per view must divide by the rays axis, the
budgets are broadcast from rank 0 after every probe, the replicas are
checked bit for bit (checksum all-reduces) after every phase transition,
and evaluation renders each chunk's rays in blocks (render_views).  Under
a comp axis of size C > 1 every rank holds the field's component blocks
of its comp index (models/vm.py): the factors, drawn whole and cut, and
their moments are checked equal over the rays group, everything else
(basis, head, poses, warp, masks, generator) over the world.  Only rank 0
prints.

Evaluation (trainer.py:1131-1333 of the JAX package): render_views
renders whole views in chunks on an eval budget probed on the rendered
poses, eval_clip_stats measures how often the static caps clip, validate
gives the PSNR of a split with the test poses sim(3)-aligned to the
learned frame, pose_error the aligned rotation and translation errors,
visualize_pose_gradient one training view's pose-gradient maps.  None of
them draws from the torch generator, and only eval_clip_stats draws from
the numpy one (as JAX's does), so a run with mid-run validation trains
as one without.
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
from ..models import alpha_mask as am_lib
from ..models import vm as vm_lib
from ..models.shading import HEAD_NAMES
from ..parallel import sharding
from ..parallel.mesh import mesh_from_options
from ..ops import blur as blur_ops
from ..ops import kernels as kernel_ops
from ..ops import sobel
from ..geometry.ndc import convert_ndc
from ..geometry.rays import get_center_and_ray
from ..ops.composite import transmittance
from ..render.renderer import (BlurSpec, RenderConfig, render_rays,
                               sample_ray_axes, step_size)
from ..sched import schedules
from ..utils.torch_setup import resolve_device, setup_torch
from .step import (StepConfig, StepScalars, compose_train_pose,
                   init_train_state, rebuild_opt_state, train_step)

# (dotted key, the value or values the port runs); others raise.  None,
# False and 0 all mean "off".  The six VM variant flags (arch.abs_components
# ... arch.ignore_negative_split) run at either value and are read with
# bool(), as JAX reads them; optim.sched_pose.type at any value, as JAX's
# trainer runs it: ExponentialLR, else the lambda schedule
# optim.sched_pose.lr_pose_schedule when given, else a constant pose lr.
_PORTED_VALUES = (
    ("model", ("bat", "tensorf", "l2g_bat")),
    ("camera.ndc", (None, False, True)),
    ("tpu.factor_dtype", ("float32", "bfloat16")),
    ("tpu.densify_impl", ("packed8", "lane")),
    ("tpu.plane_scatter", ("xla", "segsum", "runsum")),
    ("arch.tensorf.model", ("BAT_VMSplit", "TensorVMSplit", "BAT_CP",
                            "TensorCP")),
    ("arch.shading.model", HEAD_NAMES),
    ("arch.shading.predict_density", (None, False, True)),
    ("arch.shading.detach_viewdirs", (None, False, True)),
    ("arch.shading.detach_xyz", (None, False, True)),
    ("arch.feature_to_density_activation", ("softplus", "relu")),
    ("nerf.setbg_opaque", (None, False, True)),
    ("nerf.sample_stratified", (None, False, True)),
    ("nerf.ray_sampling_strategy", ("all_view_rand_grid",
                                    "all_view_rand_rays",
                                    "single_view_rand_rays")),
)

# The tpu: keys.  Those in _PORTED_VALUES run only at the values named
# there: tpu.densify_impl packed8 and lane are one sampler here
# (ops/densify.py; lane's 128-lane row layout is a TPU tiling with no
# function of its own); tpu.plane_scatter's xla / segsum / runsum compute
# one function, which K3 computes.  tpu.densify_dtype runs at float32 and
# bfloat16 (_DENSIFY_DTYPES, named with the layout when refused): the JAX
# renderer reads it only under densify_impl lane (the bf16 row reads) and
# computes float32 under packed8 whatever it says, as the port does.
# tpu.mesh_shape runs over a rays and a comp axis (_check_mesh).  The
# others run at any value: tpu.mesh_axes matters only with a mesh,
# tpu.donate_state is an XLA buffer choice with no counterpart.  A tpu:
# key in none of these raises.
_DENSIFY_DTYPES = ("float32", "bfloat16")
_TPU_ANY_VALUE = (
    "mesh_axes", "donate_state", "densify_density", "bbox_compact",
    "blur_mask_compact", "blur_mask_refresh", "mask_res_cap",
    "mask_cap_voxels", "densify_min_samples_per_chip", "app_k",
    "app_k_auto", "app_k_max", "app_k_dense_only", "mask_stride",
    "eval_app_k")


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (a later slice "
                               f"of the PyTorch port)")


def _off(v) -> bool:
    return v is None or v is False or (isinstance(v, (int, float)) and v == 0)


_POSE_MODELS = ("bat", "l2g_bat")


def _check_mesh(opt: Options):
    """tpu.mesh_shape runs over the ``rays`` and ``comp`` axes (any other
    axis of size 1).  Under a comp axis of size C every component count
    must divide by C (ValueError naming the count, as JAX's device_put of
    a ``P(..., "comp")`` sharding refuses it)."""
    shape = opt.get_path("tpu.mesh_shape")
    if not shape:
        return
    axes = list(opt.get_path("tpu.mesh_axes") or ["rays"])
    split = {a: int(n) for a, n in zip(axes, shape)
             if a not in ("rays", "comp") and int(n) > 1}
    if split:
        names = ", ".join(f"{a} axis of size {n}" for a, n in split.items())
        raise _unported(f"option tpu.mesh_shape={list(shape)} with "
                        f"tpu.mesh_axes={axes}: the {names} (the rays and "
                        f"comp axes are ported)")
    c = dict(zip(axes, (int(n) for n in shape))).get("comp", 1)
    for key in ("density_components", "color_components"):
        for i, n in enumerate(opt.arch.tensorf.get(key) or ()):
            if int(n) % c:
                raise ValueError(
                    f"arch.tensorf.{key}[{i}]={int(n)} does not divide by "
                    f"the comp axis ({c}) of tpu.mesh_shape={list(shape)} "
                    f"with tpu.mesh_axes={axes}")


def check_ported(opt: Options):
    """Raise NotImplementedError naming the first option whose value the
    port does not run, or a tpu: key it does not know; ValueError when
    arch.shading.predict_density and the head disagree (the JAX renderer
    unpacks a head's output by that flag, and fails on a mismatch)."""
    for key, want in _PORTED_VALUES:
        got = opt.get_path(key)
        ok = (_off(got) if _off(want)
              else got in want if isinstance(want, tuple) else got == want)
        if not ok:
            raise _unported(f"option {key}={got!r}")
    impl = opt.get_path("tpu.densify_impl")
    dtype = opt.get_path("tpu.densify_dtype") or "float32"
    if dtype not in _DENSIFY_DTYPES:
        raise _unported(f"option tpu.densify_dtype={dtype!r} under "
                        f"tpu.densify_impl={impl!r}")
    head = str(opt.arch.shading.model)
    predict = bool(opt.arch.shading.get("predict_density", False))
    if predict != (head == "MLP_Fea_WeakView_Density"):
        raise ValueError(f"arch.shading.predict_density={predict} with "
                         f"arch.shading.model={head!r}: only "
                         f"MLP_Fea_WeakView_Density predicts the density")
    _check_mesh(opt)
    checked = {k[4:] for k, _ in _PORTED_VALUES if k.startswith("tpu.")}
    checked.update(("densify_dtype", "mesh_shape"))
    for key in opt.get("tpu") or {}:
        if key not in checked and key not in _TPU_ANY_VALUE:
            raise _unported(f"option tpu.{key}")


def build_vm_config(opt: Options) -> vm_lib.VMConfig:
    """The JAX trainer's build_vm_config (trainer.py:44-69), quirks
    included: it compares the arch.shading dict with "RGB", which never
    holds, so the RGB head takes arch.shading.app_dim (and refuses any but
    3); "CP" anywhere in arch.tensorf.model means the CP decomposition;
    pos_pe is arch.shading.pose_pe."""
    arch = opt.arch
    return vm_lib.VMConfig(
        density_n_comp=tuple(int(c) for c in arch.tensorf.density_components),
        app_n_comp=tuple(int(c) for c in arch.tensorf.color_components),
        app_dim=3 if arch.shading == "RGB" else int(arch.shading.app_dim),
        shading_mode=str(arch.shading.model),
        view_pe=int(arch.shading.view_pe),
        pos_pe=int(arch.shading.pose_pe),
        fea_pe=int(arch.shading.fea_pe),
        hidden=int(arch.shading.mlp_hidden_dim),
        fea2dense=str(arch.feature_to_density_activation),
        density_shift=float(arch.density_shift),
        distance_scale=float(arch.distance_scale),
        raymarch_weight_thres=float(arch.tensorf.rayMarch_weight_thres),
        step_ratio=float(opt.nerf.step_ratio),
        decomposition="CP" if "CP" in arch.tensorf.model else "VM",
        abs_components=bool(arch.get("abs_components", False)),
        component_wise_feature2density=bool(
            arch.get("component_wise_feature2density", False)),
        plane_feature2density=bool(arch.get("plane_feature2density", False)),
        convolve_plane_only=bool(arch.get("convolve_plane_only", False)),
        convolve_positive_only=bool(arch.get("convolve_positive_only",
                                             False)),
        ignore_negative_split=bool(arch.get("ignore_negative_split", False)),
        factor_dtype=str(opt.tpu.get("factor_dtype") or "float32"),
    )


class Trainer:
    """Tensorial-field training: joint with the camera poses (BAT,
    ``model: bat``) or at the given poses (TensoRF, ``model: tensorf``:
    no pose noise, no factor blur, no near-plane schedule, no pose
    learning rate, validation without alignment)."""

    def __init__(self, opt: Options, train_data: SceneData,
                 val_data: Optional[SceneData] = None, device=None):
        check_ported(opt)
        setup_torch()
        self.opt = opt
        self.val_data = val_data
        # the rank's mesh (None without tpu.mesh_shape) and its device
        self.mesh = mesh_from_options(opt, resolve_device(device))
        self.device = dev = (self.mesh.device if self.mesh is not None
                             else resolve_device(device))
        self.it = 0
        self.max_iter = int(opt.max_iter)
        seed = int(opt.get("seed", 0))
        self.rng_np = np.random.default_rng(seed)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.is_bat = opt.model in _POSE_MODELS
        self.ndc = bool(opt.camera.get("ndc", False))
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
        sched_pose = o.get("sched_pose") or {}
        # ExponentialLR at lr_pose 0 falls back to the lambda schedule or
        # the constant, as in JAX (trainer.py:147-158)
        self.pose_exponential = (sched_pose.get("type") == "ExponentialLR"
                                 and self.lr_pose0 > 0)
        self.pose_gamma = ((float(o.lr_pose_end) / self.lr_pose0) ** (
            1.0 / self.max_iter) if self.pose_exponential else 1.0)
        self.pose_lambda_schedule = (
            list(sched_pose.lr_pose_schedule)
            if sched_pose.get("lr_pose_schedule") else None)
        self.warmup_pose = o.get("warmup_pose")
        # the TV weights decay with the learning rate
        lw = opt.loss_weight
        self.tv_density_weight = float(lw.get("TV_density", 0.0) or 0.0)
        self.tv_color_weight = float(lw.get("TV_color", 0.0) or 0.0)

        # ---------------- pose noise: base = GT o noise (the SE(3) noise
        # matrices are kept: the checkpoint stores them)
        V, H, W = train_data.n_views, train_data.H, train_data.W
        self.n_views, self.H, self.W = V, H, W
        self.gt_poses = torch.as_tensor(train_data.poses, device=dev)
        self.pose_noise: Optional[torch.Tensor] = None
        if self.is_bat and opt.camera.get("noise"):
            se3_noise = torch.randn((V, 6), generator=self.generator,
                                    device=dev) * float(opt.camera.noise)
            self.pose_noise = lie.se3_to_SE3(se3_noise)
        self.pose_base = (self.gt_poses if self.pose_noise is None else
                          pose_ops.compose([self.pose_noise, self.gt_poses]))

        # ---------------- device-side dataset
        self.images_chw = torch.as_tensor(train_data.images, device=dev)
        self.images_sharp = self.images_chw.reshape(V, 3, H * W).transpose(
            1, 2).contiguous()                                   # [V,HW,3]
        self.intr = torch.as_tensor(train_data.intr, device=dev)
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
        # the comp layout's handle: the mesh when it splits the components
        self.comp = (self.mesh if self.mesh is not None and self.mesh.comp > 1
                     else None)
        field = vm_lib.init_vm(
            self.vm_cfg, self.resolution, self.bbox, self.generator,
            init_scale=float(opt.arch.tensorf.get("volume_init_scale", 0.1)),
            init_bias=float(opt.arch.tensorf.get("volume_init_bias", 0.0)),
            device=dev, comp=self.comp)
        self.state = self._init_state(field)
        self.metrics_history: list[dict] = []

        # ---------------- sample-compaction budgets (None: all S slots)
        self.compact_k: Optional[int] = None        # under the alpha mask
        self.app_k_dyn: Optional[int] = None        # raised tpu.app_k
        self.compact_k_bbox: Optional[int] = None   # in-bbox gate alone
        self.alpha_mask_blur: Optional[am_lib.AlphaMask] = None
        self.compact_k_blur: Optional[int] = None   # dilated mask, blur on
        self._blur_mask_built_at: Optional[int] = None
        self.last_step_config: Optional[StepConfig] = None
        self.last_eval_config: Optional[RenderConfig] = None
        self._verify_replicas("initialisation")
        self._refresh_bbox_k()

    def _init_state(self, field: vm_lib.VMField):
        """The train state around the initial field: the zero pose table,
        or with start_with_GT_pose on LLFF / t2 captures the GT poses' log
        (the JAX trainer's __init__); L2GTrainer builds its own."""
        state = init_train_state(field, self.n_views)
        if self.is_bat and self.opt.get("start_with_GT_pose") and \
                self.opt.data.dataset in ("llff", "t2"):
            with torch.no_grad():
                state.se3_refine.copy_(lie.SE3_to_se3(self.gt_poses))
        return state

    # ------------------------------------------------------------- the mesh
    @property
    def is_main(self) -> bool:
        """The rank that prints and writes files (every rank without a
        mesh)."""
        return self.mesh is None or self.mesh.is_main

    def _replica_tensors(self) -> dict:
        """Every tensor the replicas must hold equal: the state (field,
        pose table or warp, moments, accumulators, registered poses, error
        map), the alpha masks and the torch generator's state (under the
        comp layout the factor blocks and their moments only within a
        rays group: _replica_groups)."""
        st = self.state
        out = {f"field.{k}": v for k, v in st.field.state_dict().items()}
        if hasattr(st, "warp_mlp"):
            out.update({f"warp_mlp.{k}": v
                        for k, v in st.warp_mlp.state_dict().items()})
        for name in ("se3_refine", "warp_embedding", "optimised_poses",
                     "error_map", "pose_grad_accum"):
            v = getattr(st, name, None)
            if isinstance(v, dict):
                out.update({f"{name}.{k}": t for k, t in v.items()})
            elif v is not None:
                out[name] = v
        for name in ("scene_opt", "pose_opt"):
            for m in ("mu", "nu"):
                out.update({f"{name}.{m}.{k}": t for k, t in
                            getattr(getattr(st, name), m).items()})
        for name in ("alpha_mask", "alpha_mask_blur"):
            mask = getattr(self, name, None)
            if mask is not None:
                out[f"{name}.grid"], out[f"{name}.aabb"] = mask.grid, mask.aabb
        out["generator"] = self.generator.get_state()
        return out

    def _replica_groups(self) -> dict:
        """_replica_tensors by the group that holds them equal: {None (the
        world): ..., "rays": the factor blocks and their moments} under
        the comp layout, everything over the world otherwise."""
        tensors = self._replica_tensors()
        if self.comp is None:
            return {None: tensors}
        field = self.state.field
        # field.<name> and scene_opt.<mu|nu>.<name>
        blocks = {k for k in tensors if k.startswith("field.")
                  and field.is_factor(k[6:]) or k.startswith("scene_opt.")
                  and field.is_factor(k.split(".", 2)[2])}
        return {None: {k: v for k, v in tensors.items() if k not in blocks},
                "rays": {k: tensors[k] for k in blocks}}

    def _verify_replicas(self, what: str):
        """Under a mesh: raise unless every rank holds the same bits (the
        factor blocks: every rank of its rays group)."""
        if self.mesh is not None:
            for axis, tensors in self._replica_groups().items():
                sharding.verify_replicas(self.mesh, tensors, what, axis=axis)

    def _sync_budgets(self):
        """Under a mesh: rank 0's compaction budgets on every rank, so that
        no rank can compile another shape (the probes run on every rank)."""
        if self.mesh is None:
            return
        blur = self.compact_k_blur
        (self.compact_k_bbox, self.compact_k_blur, self.compact_k,
         self.app_k_dyn) = sharding.broadcast_ints(
            self.mesh, [self.compact_k_bbox, self.compact_k_blur,
                        self.compact_k, self.app_k_dyn])
        if (blur is None) != (self.compact_k_blur is None):
            raise RuntimeError(f"rank {self.mesh.rank} built the blur mask "
                               f"budget {blur}, rank 0 {self.compact_k_blur}")

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
        # no blur without BAT or a mode, or below the kernel-drop epsilon
        if not self.is_bat or opt.get("c2f_mode", "None") in (None, "None") \
                or max(c2f_d, c2f_c) < 1e-3:
            return None
        return BlurSpec(mode=opt.c2f_mode, kernel_size=int(opt.c2f_kernel_size))

    def _c2f_params(self):
        """(c2f_density, c2f_color, scale_2d) for this iteration; draws the
        2D scale, then the density scale, from rng_np.  With
        sync_2d_3d_scales the density scale is the 2D scale just drawn,
        and rng_np draws no second time."""
        opt = self.opt
        if not self.is_bat or opt.get("c2f_mode", "None") in (None, "None"):
            return 0.0, 0.0, 0.0
        d = schedules.interp_schedule(self.progress, opt.c2f_schedule_density)
        c = schedules.interp_schedule(self.progress, opt.c2f_schedule_color)
        sc2d = 0.0
        if self.blur_2d and opt.get("c2f_alternate_2D_blur"):
            sc2d = float(self.rng_np.choice(self.scale_pool_2d))
        if opt.get("c2f_random_density_blur"):
            if opt.get("sync_2d_3d_scales"):
                d = d * sc2d
            else:
                d = d * float(self.rng_np.choice(
                    opt.c2f_random_density_scale_pool))
        return float(d), float(c), sc2d

    def _near_far(self):
        opt = self.opt
        if self.is_bat and opt.data.dataset != "blender" and \
                opt.get("tensorf_near_plane_schedule") is not None:
            near = schedules.interp_schedule(
                self.progress, opt.tensorf_near_plane_schedule)
            return [float(near), self.near_far[1]]
        return self.near_far

    def _strategy(self) -> str:
        ts = self.opt.train_schedule
        strat = self.opt.nerf.ray_sampling_strategy
        if ts.get("all_view_sample_after_n_iters") is not None and \
                self.it >= ts.all_view_sample_after_n_iters:
            strat = "all_view_rand_rays"
        if ts.get("single_view_sample_after_n_iters") is not None and \
                self.it >= ts.single_view_sample_after_n_iters:
            strat = "single_view_rand_rays"
        return strat

    def _lr_pose(self) -> float:
        """The pose lr (trainer.py:463-474): exponential decay, or the
        lambda schedule (optim.sched_pose.lr_pose_schedule, interpolated
        over the progress: the lr itself, as JAX reads it), or
        constant; then the warm-up."""
        if not self.is_bat:
            return 0.0
        if self.pose_exponential:
            lr = self.lr_pose0 * self.pose_gamma ** self.it
        elif self.pose_lambda_schedule is not None:
            lr = schedules.interp_schedule(self.progress,
                                           self.pose_lambda_schedule)
        else:
            lr = self.lr_pose0
        if self.warmup_pose:
            lr *= min(1.0, self.it / float(self.warmup_pose))
        return float(lr)

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
        """Blur the GT images and build the edge masks (soft with
        soft_edge_mask, else hard) for every scale in the pool (runs every
        500 iterations)."""
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
            mask = (sobel.soft_edge_mask(imgs_chw)
                    if opt.get("soft_edge_mask")
                    else sobel.hard_edge_mask(imgs_chw, thresh))
            self.edge_masks[sc] = mask.to(torch.float32)

    # -------------------------------------------------------- ray sampling
    def _sample_rays(self, strategy: str, n_rays: int):
        """-> (view_sel [Vs], ray_idx [R], (ny, nx) or None), drawn from
        rng_np: single_view_rand_rays, view it % V and n_rays pixels of a
        permutation; all_view_rand_rays, every view and the first
        n_rays / V pixels of one permutation; all_view_rand_grid, a
        regular pixel grid with a random offset, the same for every
        view."""
        V, H, W = self.n_views, self.H, self.W
        if strategy == "single_view_rand_rays":
            idx = self.rng_np.permutation(H * W)[:n_rays]
            return np.array([self.it % V]), idx.astype(np.int64), None
        if strategy == "all_view_rand_rays":
            idx = self.rng_np.permutation(H * W)[:max(1, n_rays // V)]
            return np.arange(V), idx.astype(np.int64), None
        if strategy != "all_view_rand_grid":
            raise ValueError(f"unknown ray sampling strategy {strategy!r}")
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
        view_sel, ray_idx, grid_hw = self._sample_rays(self._strategy(),
                                                       self._n_rays())
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
            tv_depth_weight=self._tv_depth_weight(),
            tv_density_weight=self.tv_density_weight,
            tv_color_weight=self.tv_color_weight)
        return scalars, blur_spec, view_sel, ray_idx, grid_hw, sc2d

    def _reset_poses(self):
        """Zero the pose table (not its moments) at reset_pose_on_iter,
        each of reset_pose_on_iters and, with
        reset_pose_on_first_upsample, the first upsample's iteration
        (trainer.py:714-725); L2G-BAT has no table to reset."""
        ts = self.opt.train_schedule
        its = set(int(i) for i in ts.get("reset_pose_on_iters") or [])
        if ts.get("reset_pose_on_iter") is not None:
            its.add(int(ts.reset_pose_on_iter))
        if ts.get("reset_pose_on_first_upsample") and self.upsample_iters:
            its.add(int(self.upsample_iters[0]))
        if self.it in its and hasattr(self.state, "se3_refine"):
            with torch.no_grad():
                self.state.se3_refine.zero_()

    def train_iteration(self, stats: bool = False, jitter=None,
                        bg_coin=None, **draws):
        """One step; ``stats`` adds the step's sample fractions and blur
        flag to its metrics (train_step); ``jitter`` ([rays, 1], or
        [rays, S] under NDC) and ``bg_coin``: pre-drawn stratified offsets
        and background coin (else drawn from the trainer's generator);
        ``draws``: the step's other pre-drawn inputs (L2G's
        error_draws)."""
        self._reset_poses()
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
        metrics, _ = self._step(
            cfg, torch.as_tensor(view_sel, device=self.device),
            torch.as_tensor(ray_idx, device=self.device), scalars,
            generator=self.generator, jitter=jitter, bg_coin=bg_coin,
            alpha_mask=self._step_mask(blur_spec is not None), stats=stats,
            mesh=self.mesh, **draws)
        return metrics

    def _step(self, cfg: StepConfig, view_sel, ray_idx, scalars, **kw):
        """The training step on this trainer's state and data (the hook
        L2GTrainer replaces, as the JAX trainer's _make_raw_step)."""
        return train_step(self.state, cfg, self.vm_cfg, self.pose_base,
                          self.intr_inv, self.current_images,
                          self.current_edges, view_sel, ray_idx, scalars,
                          intr=self.intr, **kw)

    def _step_mask(self, blur_active: bool) -> Optional[am_lib.AlphaMask]:
        """The mask that gates the step's samples: the JAX trainer's step
        mask with its use_alpha_mask / mask_with_blur gate applied.  Under
        the blur, the dilated mask while it has a budget (else none: the
        sharp mask would cull what the blur spreads); without it, the alpha
        mask once built."""
        return self.alpha_mask_blur if blur_active else self.alpha_mask

    def _samples_per_chip(self, rays_per_view: int) -> int:
        """Density samples each rank evaluates per step: the dense-grid
        gate's measure (trainer.py:560-574).  The O(XYZ) dense-grid build
        is replicated on every rank while the sample work divides by the
        rays axis, so the gate keys on samples per rank."""
        return (rays_per_view * self.n_views * self.n_samples
                // (self.mesh.rays if self.mesh is not None else 1))

    def _step_config(self, rays_per_view: int, blur: Optional[BlurSpec],
                     grid_hw) -> StepConfig:
        """The JAX trainer's _ensure_step choice (trainer.py:576-650):
        under the blur, compact on the dilated mask's budget when there is
        one, else on the in-bbox budget; without the blur, on the alpha
        mask's budget once a mask is built.  The dense grid runs while the
        blur is on or no mask is built, and only past
        tpu.densify_min_samples_per_chip samples per rank.  Under a mesh
        the rays per view must divide by the rays axis
        (trainer.py:660-664)."""
        tpu = self.opt.tpu
        if self.mesh is not None:
            sharding.ray_block(self.mesh, rays_per_view)
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
                   and self._samples_per_chip(rays_per_view) >= int(
                       tpu.get("densify_min_samples_per_chip", 100000)))
        lane = str(tpu.get("densify_impl", "packed8")) == "lane"
        return StepConfig(
            H=self.H, W=self.W, n_views=self.n_views,
            rays_per_view=rays_per_view, n_samples=self.n_samples,
            pose_opt=self.is_bat, blur=blur, grid_hw=grid_hw, mask_stride=self.mask_stride,
            compact_k=compact_k, densify_density=densify,
            densify_dtype=(str(tpu.get("densify_dtype") or "float32")
                           if lane else "float32"), app_k=app_k,
            pin_first_pose=bool(self.opt.train_schedule.get(
                "pin_first_pose", False)),
            stratified=bool(self.opt.nerf.get("sample_stratified", True)),
            detach_viewdirs=bool(self.opt.arch.shading.get(
                "detach_viewdirs", True)),
            detach_xyz=bool(self.opt.arch.shading.get("detach_xyz", True)),
            **self._ray_options())

    def _ray_options(self) -> dict:
        """The background, NDC and density-head choices of the config, as
        the JAX trainer reads them for its training and evaluation
        renders."""
        opt = self.opt
        return dict(
            mlp_predict_density=bool(opt.arch.shading.get("predict_density",
                                                          False)),
            white_bg=bool(opt.nerf.get("setbg_opaque", True)), ndc=self.ndc,
            ndc_near_plane=float(opt.arch.get("ndc_near_plane", 1.0)),
            ndc_simulate_euclid_sample=bool(
                opt.get("ndc_simulate_euclid_sample", False)),
            ndc_simulate_euclid_depth=bool(
                opt.get("ndc_simulate_euclid_depth", False)))

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
            reset = self.opt.train_schedule.get("reset_on_last_upsample")
            if reset and it == self.upsample_iters[-1] and any(
                    reset.get(k) for k in ("density", "appearance", "basis")):
                self._replace_field(lambda f: self._reinit_groups(
                    vm_lib.upsample(f, res), reset))
            else:
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
        if it in self.upsample_iters or it in self.update_alphamask_iters:
            self._verify_replicas(f"the transition after it {it}")
        if self.tv_density_weight > 0:
            self.tv_density_weight *= self.decay_factor
        if self.tv_color_weight > 0:
            self.tv_color_weight *= self.decay_factor

    def _reinit_groups(self, field: vm_lib.VMField, reset) -> vm_lib.VMField:
        """reset_on_last_upsample (trainer.py:807-816): the groups it names
        drawn anew at the field's resolution (without the init bias, as in
        JAX), the others and the shading head carried over."""
        return vm_lib.init_vm(
            self.vm_cfg, field.resolution(), field.aabb, self.generator,
            init_scale=float(self.opt.arch.tensorf.get("volume_init_scale",
                                                       0.1)),
            device=self.device, init_density=bool(reset.get("density")),
            init_app=bool(reset.get("appearance")),
            init_basis=bool(reset.get("basis")), prev=field)

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
        self._sync_budgets()
        if not capped and it == self.update_alphamask_iters[0] and \
                opt.train_schedule.get("shrink_bbox_with_alphamask", True):
            self._replace_field(lambda f: vm_lib.shrink(f, new_aabb))
            self._refresh_bbox_k()

    # ------------------------------------------------ compaction budgets
    def get_all_training_poses(self):
        """(poses [V,3,4], GT poses): the learned refinement composed on
        GT o noise for every view (the base poses without BAT)."""
        views = torch.arange(self.n_views, device=self.device)
        pose = compose_train_pose(self.state.se3_refine.detach(),
                                  self.pose_base, views, self.is_bat)
        return pose, self.gt_poses

    def _probe_rays(self, rng: np.random.Generator, n_probe_rays: int,
                    poses=None, intr_inv=None):
        """(centers, dirs) [n, 3] of every view's first n_probe_rays / V
        pixels of a permutation drawn from ``rng``: the views of ``poses``
        with ``intr_inv``, the training views by default."""
        if poses is None:
            poses, _ = self.get_all_training_poses()
            intr_inv = self.intr_inv
        per_view = max(1, n_probe_rays // poses.shape[0])
        idx = torch.as_tensor(rng.permutation(self.H * self.W)[:per_view],
                              device=self.device)
        centers, dirs = get_center_and_ray(self.H, self.W, poses, intr_inv,
                                           ray_idx=idx)
        return centers.reshape(-1, 3), dirs.reshape(-1, 3)

    @torch.no_grad()
    def _probe_compact_k(self, n_probe_rays: int = 4096, poses=None,
                         intr_inv=None, pad: float = 1.25,
                         bbox_only: bool = False,
                         mask: Optional[am_lib.AlphaMask] = None):
        """The compaction budget K (trainer.py:891-1004): the most live
        sample slots of any probe ray, counted as the renderer selects
        them (live probe groups x stride: alpha probed at each group's
        first sample, and any of its samples in the box), times ``pad``,
        rounded up to a multiple of 128 (at least 128); None when K would
        reach S.  ``bbox_only`` counts the in-bbox gate alone.  The probe
        rays cross every view of ``poses`` (with ``intr_inv``; the
        training views by default).  They come from the training generator
        for the alpha mask's probe on the training views, from
        default_rng(0) on given (evaluation) poses, and from
        default_rng(seed + 12345) for the in-bbox and blur-mask probes:
        only the first moves the training draws.  None under NDC, as in
        JAX."""
        if self.ndc:
            return None
        probe_mask = mask if mask is not None else self.alpha_mask
        if probe_mask is None and not bbox_only:
            return None
        rng = self.rng_np if poses is None else np.random.default_rng(0)
        if bbox_only or mask is not None:
            rng = np.random.default_rng(int(self.opt.get("seed", 0)) + 12345)
        centers, dirs = self._probe_rays(rng, n_probe_rays, poses, intr_inv)
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
        # feature2density on the feature as JAX's probes apply it, also
        # to a component-wise activated one
        sigma = vm_lib.feature2density(
            self.vm_cfg, vm_lib.compute_density_feature(
                field, self.vm_cfg, coords)).reshape(n, S)
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
        if k != base and self.is_main:
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
        self._sync_budgets()

    def _blur_sigma_max(self, lookahead_iters: int) -> float:
        """The largest world sigma of the density blur over the next
        ``lookahead_iters`` iterations: the piecewise-linear schedule at
        both ends and at every knot between, times the largest random
        scale (trainer.py:260-281): the 2D pool's with sync_2d_3d_scales."""
        opt = self.opt
        p0 = self.progress
        p1 = min(1.0, (self.it + lookahead_iters) / self.max_iter)
        sched = list(opt.c2f_schedule_density)
        knots = np.linspace(0.0, 1.0, len(sched))
        pts = [p0, p1] + [float(k) for k in knots if p0 < k < p1]
        d = max(float(schedules.interp_schedule(p, sched)) for p in pts)
        if opt.get("c2f_random_density_blur"):
            pool = (self.scale_pool_2d if opt.get("sync_2d_3d_scales")
                    else opt.c2f_random_density_scale_pool)
            d *= max(float(s) for s in pool)
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
        if not bool(opt.tpu.get("blur_mask_compact", True)) or self.ndc:
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
        self._sync_budgets()
        if k is not None and self.is_main:
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

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def render_views(self, pose, intr, intr_inv, chunk: int = 4096,
                     on_chunk=None):
        """Whole views [V, H*W] of ``pose`` [V, 3, 4] in chunks of ``chunk``
        rays (trainer.py:1139-1196) -> (rgb [V, H*W, 3], depth, opacity
        [V, H*W]).  The compaction budget is probed on these poses with
        pad 1.5; the dense grid runs only when that probe leaves no budget;
        the appearance is dense unless tpu.eval_app_k sets a cap.  Samples
        are not stratified; the training mask stride and the alpha mask,
        no blur, no background coin.  ``intr`` converts the rays under
        NDC.  ``on_chunk(i)`` runs after chunk i.  Under a mesh each rank
        renders its block of every chunk (the budget broadcast from rank
        0) and the blocks are gathered (sharding.render_sharded)."""
        pose = torch.as_tensor(pose, device=self.device)
        intr_inv = torch.as_tensor(intr_inv, device=self.device)
        tpu = self.opt.tpu
        eval_k = self._probe_compact_k(poses=pose, intr_inv=intr_inv, pad=1.5)
        if self.mesh is not None:
            eval_k, = sharding.broadcast_ints(self.mesh, [eval_k])
        rcfg = RenderConfig(
            n_samples=self.n_samples, is_train=False,
            mask_stride=self.mask_stride, compact_k=eval_k,
            densify_density=(bool(tpu.get("densify_density", True))
                             and eval_k is None),
            app_k=int(tpu.eval_app_k) if tpu.get("eval_app_k") else None,
            **self._ray_options())
        self.last_eval_config = rcfg
        V = pose.shape[0]
        centers, dirs = get_center_and_ray(self.H, self.W, pose, intr_inv)
        if self.ndc:
            centers, dirs = convert_ndc(
                centers, dirs, torch.as_tensor(intr, device=self.device),
                near=rcfg.ndc_near_plane)
        centers, dirs = centers.reshape(-1, 3), dirs.reshape(-1, 3)
        near_far = self._near_far()

        def render(c, d):
            return render_rays(self.state.field, self.vm_cfg, rcfg, c, d,
                               near_far, alpha_mask=self.alpha_mask)

        outs = []
        for i, s in enumerate(range(0, centers.shape[0], chunk)):
            c, d = centers[s:s + chunk], dirs[s:s + chunk]
            outs.append(render(c, d) if self.mesh is None else
                        sharding.render_sharded(self.mesh, render, c, d))
            if on_chunk:
                on_chunk(i)
        rgb, depth, opacity = (torch.cat(o) for o in zip(*outs))
        return (rgb.reshape(V, -1, 3), depth.reshape(V, -1),
                opacity.reshape(V, -1))

    @torch.no_grad()
    def eval_clip_stats(self, pose, intr_inv, n_probe_rays: int = 4096):
        """How often the static caps clip on probe rays of ``pose``
        (trainer.py:1198-1271): the eval budget (compact_k) and the
        training appearance cap tpu.app_k (app_k) against each ray's live
        sample count and its count past the weight gate; a clip rate of 0
        means those rays render exactly.  The pixel permutation comes from
        the training generator, as in JAX."""
        pose = torch.as_tensor(pose, device=self.device)
        intr_inv = torch.as_tensor(intr_inv, device=self.device)
        field = self.state.field
        S = self.n_samples
        per_view = max(1, n_probe_rays // max(1, pose.shape[0]))
        idx = torch.as_tensor(self.rng_np.permutation(self.H * self.W)[
            :per_view], device=self.device)
        centers, dirs = get_center_and_ray(self.H, self.W, pose, intr_inv,
                                           ray_idx=idx)
        centers, dirs = centers.reshape(-1, 3), dirs.reshape(-1, 3)
        tpu = self.opt.tpu
        app_k = int(tpu.app_k) if tpu.get("app_k") else None
        compact_k = self._probe_compact_k(poses=pose, intr_inv=intr_inv,
                                          pad=1.5)
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
        # feature2density on the feature as JAX's probes apply it, also
        # to a component-wise activated one
        sigma = vm_lib.feature2density(
            self.vm_cfg, vm_lib.compute_density_feature(
                field, self.vm_cfg, coords)).reshape(n, S)
        sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                           torch.zeros_like(z_vals[:, :1])], -1)
        _, _, weight = transmittance(
            1.0 - torch.exp(-sigma * dists * self.vm_cfg.distance_scale))
        n_alive = valid.sum(dim=-1).cpu().numpy()
        n_gate = ((weight > self.vm_cfg.raymarch_weight_thres) & valid).sum(
            dim=-1).cpu().numpy()
        return {"compact_k": compact_k, "app_k": app_k,
                "max_alive": int(n_alive.max()), "max_gate": int(n_gate.max()),
                "compact_clip_rate": (float((n_alive > compact_k).mean())
                                      if compact_k is not None else 0.0),
                "app_k_clip_rate": (float((n_gate > app_k).mean())
                                    if app_k is not None else 0.0)}

    def validate(self, data: Optional[SceneData] = None, align: bool = True,
                 on_chunk=None):
        """Mean PSNR over a split (the validation split by default), its
        GT poses sim(3)-aligned into the learned frame first with BAT
        (trainer.py:1273-1290) -> {"psnr", "rgb", "depth"}."""
        data = data or self.val_data
        if data is None:
            raise ValueError("validate: no split given and no val_data")
        pose = torch.as_tensor(data.poses, device=self.device)
        if self.is_bat and align:
            tr_pose, tr_gt = self.get_all_training_poses()
            _, sim3 = align_lib.prealign_cameras(tr_pose, tr_gt)
            pose = align_lib.align_test_pose(pose, sim3)
        rgb, depth, _ = self.render_views(pose, data.intr, data.intr_inv,
                                          on_chunk=on_chunk)
        V = data.n_views
        target = torch.as_tensor(data.images, device=self.device).reshape(
            V, 3, -1).transpose(1, 2)
        mse_per = torch.mean((rgb - target) ** 2, dim=(1, 2))
        return {"psnr": float(torch.mean(-10 * torch.log10(mse_per))),
                "rgb": rgb, "depth": depth}

    def visualize_pose_gradient(self, view: int = 0, n_rays_chunk: int = 256,
                                on_chunk=None):
        """Per-pixel pose-jacobian maps of training view ``view``
        (trainer.py:1292-1323) -> numpy (rot [3, H, W], trans [3, H, W]),
        by viz/grad_viz.pose_gradient_maps.  The rays are rendered as the
        JAX trainer renders them there: unstratified, all S samples with
        the factored density and the dense appearance, no alpha mask (its
        RenderConfig leaves use_alpha_mask off), coordinate gradients on,
        the config's NDC and background flags (the rays themselves stay
        Euclidean, as in JAX), and the head's density under
        arch.shading.predict_density (JAX's config leaves it off there and
        fails on the head's pair).  The field is frozen, so a chunk launches
        K1 and K2 once each and K3 not at all.  ``on_chunk(i)`` runs after
        chunk i."""
        from ..geometry.rays import camera_grid_3d
        from ..pose.test_optim import frozen
        from ..viz.grad_viz import delta_pose, pose_gradient_maps

        pose_all, _ = self.get_all_training_poses()
        pose = pose_all[view].detach()
        grid = camera_grid_3d(self.H, self.W,
                              self.intr_inv[view:view + 1])[0]  # [HW, 3]
        image = self.images_sharp[view]                          # [HW, 3]
        rcfg = RenderConfig(
            n_samples=self.n_samples, is_train=False, ndc=self.ndc,
            white_bg=bool(self.opt.nerf.get("setbg_opaque", True)),
            stop_coord_grad=False, mlp_predict_density=bool(
                self.opt.arch.shading.get("predict_density", False)))
        near_far = self._near_far()
        field = self.state.field

        def render_mse(delta, ray_idx):
            p = pose_ops.compose_pair(delta_pose(delta), pose[None])
            R, t = p[..., :3], p[..., 3:]                  # one pose a ray
            dirs = (grid[ray_idx][:, None, :] @ R)[:, 0]
            centers = -(t.transpose(-2, -1) @ R)[:, 0]
            rgb, _, _ = render_rays(field, self.vm_cfg, rcfg, centers, dirs,
                                    near_far)
            return (rgb - image[ray_idx]) ** 2

        with frozen(field):
            return pose_gradient_maps(render_mse, self.H, self.W,
                                      n_rays_chunk, device=self.device,
                                      on_chunk=on_chunk)

    @torch.no_grad()
    def pose_error(self) -> dict:
        """Mean rotation (degrees) and translation errors of the training
        poses after sim(3) alignment to GT (trainer.py:1326-1333)."""
        pose, pose_GT = self.get_all_training_poses()
        aligned, _ = align_lib.prealign_cameras(pose, pose_GT)
        r_err, t_err = align_lib.evaluate_camera_alignment(aligned, pose_GT)
        return {"rot_deg": float(torch.rad2deg(torch.mean(r_err))),
                "trans": float(torch.mean(t_err))}
