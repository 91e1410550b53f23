"""BAT (Joint-TensoRF: a VM field with joint pose refinement) as the
benchmark runs it: the field's weights from the seed, the port's Trainer
(joint_tensorf_tpu_torch/train/trainer.py) at the cell's first iteration,
the plain reference (reference/step.py) and the VM census
(census/counts.py).  The exports are those models/__init__.py lists."""
from __future__ import annotations

import copy
import dataclasses
import math
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs as inputs_lib
from benchmark.census import counts as census
from benchmark.census.frozen import warm_start_density
from benchmark.reference import field as ref_field
from benchmark.reference.step import FACTORS, Inputs, Reference, resolution
from joint_tensorf_tpu_torch.config.options import Options
from joint_tensorf_tpu_torch.data.base import SceneData
from joint_tensorf_tpu_torch.geometry import lie, poses as pose_ops
from joint_tensorf_tpu_torch.train.trainer import Trainer


# ------------------------------------------------------------- the inputs
def weight_shapes(options: dict) -> dict:
    """{name: shape} of the field at the initial resolution, in the layout
    both sides read (reference/field.py)."""
    arch, ts = options["arch"], options["train_schedule"]
    aabb = np.asarray(options["data"]["scene_bbox"], np.float32).reshape(
        2, 3).astype(np.float64)
    res = resolution(aabb, int(ts["n_voxel_init"]))
    ranks = {"density": arch["tensorf"]["density_components"],
             "app": arch["tensorf"]["color_components"]}
    shapes = {}
    for g in ("density", "app"):
        for i, (m0, m1) in enumerate(ref_field.MAT):
            shapes[f"{g}_planes.{i}"] = (res[m1], res[m0], int(ranks[g][i]))
        for i, v in enumerate(ref_field.VEC):
            shapes[f"{g}_lines.{i}"] = (res[v], int(ranks[g][i]))
    sh = arch["shading"]
    app_dim = int(sh["app_dim"])
    shapes["basis"] = (sum(int(r) for r in ranks["app"]), app_dim)
    for name, (fi, fo) in ref_field.head_layers(
            str(sh["model"]), app_dim, int(sh["view_pe"]), int(sh["fea_pe"]),
            int(sh["mlp_hidden_dim"])).items():
        shapes[f"shading.{name}.w"] = (fi, fo)
        shapes[f"shading.{name}.b"] = (fo,)
    return shapes


def make_weights(options: dict, seed: int, device) -> dict:
    """Factors |bias + scale N(0, 1)| (the configuration's
    volume_init_scale / bias), the basis and head layers U(+-1/sqrt(fan_in))
    (the biases by their layer's fan-in), drawn from one generator on the
    device in two calls."""
    shapes = weight_shapes(options)
    t = options["arch"]["tensorf"]
    scale = float(t.get("volume_init_scale", 0.1))
    bias = float(t.get("volume_init_bias", 0.0))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    factors = [k for k in shapes if k.split(".")[0] in FACTORS]
    rest = [k for k in shapes if k not in factors]
    sizes = [math.prod(shapes[k]) for k in factors]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(factors, torch.split(normal, sizes)):
        out[k] = torch.abs(bias + scale * part).reshape(shapes[k])
    sizes = [math.prod(shapes[k]) for k in rest]
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    for k, part in zip(rest, torch.split(uniform, sizes)):
        fan_in = shapes[k][0] if len(shapes[k]) == 2 else \
            shapes[k[:-1] + "w"][0]
        out[k] = (part / math.sqrt(fan_in)).reshape(shapes[k])
    return out


def make_inputs(options: dict, seed: int, start_it: int, device,
                warm_radii: float) -> Inputs:
    """The run's inputs: the scene (inputs.scene), the field's weights at
    the initial resolution from ``seed``, with ``warm_radii`` > 0 the warm
    start over boxes of +-warm_radii object radii (0: none), and the pose
    noise (inputs.pose_noise)."""
    d = options["data"]
    scene = inputs_lib.scene(options, device)
    weights = make_weights(options, seed, device)
    if warm_radii:
        field = inputs_lib.scene_field(options)
        sizes = field.radii if hasattr(field, "radii") else field.sizes
        aabb = np.asarray(d["scene_bbox"], np.float64).reshape(2, 3)
        res = resolution(np.asarray(d["scene_bbox"], np.float32).reshape(
            2, 3).astype(np.float64), int(options["train_schedule"][
                "n_voxel_init"]))
        warm_start_density(weights, field.centers, sizes, aabb, res,
                           warm_radii)
    return Inputs(opt=options, images=scene["images"], poses=scene["poses"],
                  intr=scene["intr"], intr_inv=scene["intr_inv"],
                  weights=weights,
                  noise_se3=inputs_lib.pose_noise(options, device),
                  seed=int(seed), start_it=int(start_it))


# ------------------------------------------------------------ the program
class SpanTrainer(Trainer):
    """The Trainer with a host span around each call of the step (the hook
    L2GTrainer overrides)."""
    spans = False

    def _step(self, cfg, view_sel, ray_idx, scalars, **kw):
        t0 = time.perf_counter()
        if self.spans:
            with record_function("bench.train_step"):
                out = super()._step(cfg, view_sel, ray_idx, scalars, **kw)
        else:
            out = super()._step(cfg, view_sel, ray_idx, scalars, **kw)
        self.step_s.append(time.perf_counter() - t0)
        return out


def params(trainer) -> dict:
    out = dict(trainer.state.field.named_parameters())
    out["se3_refine"] = trainer.state.se3_refine
    return out


ADAM_B1 = 0.9    # the b1 train/step.py leaves at adam_update's default


def first_grad_norms(trainer) -> dict:
    """After the first step, the norm of each leaf's gradient as Adam
    received it: its first moment over 1 - b1 (the moments start at zero)."""
    mu = dict(trainer.state.scene_opt.mu)
    mu["se3_refine"] = trainer.state.pose_opt.mu["se3_refine"]
    return {k: torch.linalg.vector_norm(m) / (1 - ADAM_B1)
            for k, m in mu.items()}


@torch.no_grad()
def build(inputs: Inputs, device) -> SpanTrainer:
    """The Trainer at the cell's first iteration, on a copy of the images
    (the reference reads them after): the benchmark's weights and pose
    noise installed at the initial resolution, then every schedule update
    before the first iteration (upsamples, alpha masks, budget probes,
    learning rates), then its two generators seeded from the run's seed.
    Nothing else of the program is called: it is reached through the
    Trainer's attributes, which a later change may give a public form."""
    inputs = dataclasses.replace(inputs, images=inputs.images.clone())
    opt = Options(copy.deepcopy(inputs.opt))
    V, _, H, W = inputs.images.shape
    data = SceneData(images=inputs.images, poses=inputs.poses,
                     intr=inputs.intr, intr_inv=inputs.intr_inv,
                     near_far=tuple(float(v) for v in
                                    opt.nerf.depth.range), H=H, W=W)
    trainer = SpanTrainer(opt, data, device=device)
    trainer.step_s = []
    fields = dict(trainer.state.field.named_parameters())
    if set(fields) != set(inputs.weights):
        raise ValueError(f"the field's parameters {sorted(fields)} are not "
                         f"the benchmark's {sorted(inputs.weights)}")
    for k, p in fields.items():
        if tuple(p.shape) != tuple(inputs.weights[k].shape):
            raise ValueError(f"{k}: the field holds {tuple(p.shape)}, the "
                             f"benchmark {tuple(inputs.weights[k].shape)}")
        p.copy_(inputs.weights[k])
    if inputs.noise_se3 is not None:
        trainer.pose_noise = lie.se3_to_SE3(inputs.noise_se3.to(device))
        trainer.pose_base = pose_ops.compose([trainer.pose_noise,
                                              trainer.gt_poses])
        trainer._refresh_bbox_k()
    for it in range(inputs.start_it):
        trainer.it = it
        trainer._update_schedule()
    trainer.it = inputs.start_it
    trainer.rng_np = np.random.default_rng(inputs.seed)
    trainer.generator.manual_seed(inputs.seed)
    return trainer


def describe(trainer) -> str:
    """Before the first step, the schedule's state; after, the last step's
    configuration."""
    cfg = trainer.last_step_config
    if cfg is None:
        return (f"iteration {trainer.it}, resolution {trainer.resolution}, "
                f"S {trainer.n_samples}, budgets K {trainer.compact_k} / "
                f"bbox {trainer.compact_k_bbox} / blur "
                f"{trainer.compact_k_blur}, app_k {trainer.app_k_dyn}")
    return (f"step config: rays {trainer.rays_per_step}, compact_k "
            f"{cfg.compact_k}, app_k {cfg.app_k}, dense grid "
            f"{cfg.densify_density}, blur {cfg.blur is not None}")


# ----------------------------------------------------------- the schedule
def start_iteration(options: dict, anchor: dict) -> int:
    """One past ``anchor["index"]`` of the schedule list
    ``train_schedule.<anchor["after"]>``."""
    ts = options["train_schedule"]
    return int(list(ts[anchor["after"]])[int(anchor["index"])]) + 1


def schedule_moves(options: dict, start: int, n: int) -> list:
    """The upsamples and alpha-mask updates in [start, start + n)."""
    ts = options["train_schedule"]
    return [t for t in list(ts["upsample_iters"]) + list(
        ts.get("update_alphamask_iters") or []) if start <= t < start + n]


# ------------------------------------------------------------- the census
def step_shape(cell, ref: dict) -> census.StepShape:
    o = cell.config["options"]
    t, sh = o["arch"]["tensorf"], o["arch"]["shading"]
    layers = ref_field.head_layers(str(sh["model"]), int(sh["app_dim"]),
                                   int(sh["view_pe"]), int(sh["fea_pe"]),
                                   int(sh["mlp_hidden_dim"]))
    return census.StepShape(
        n_rays=ref["rays"],
        n_valid=statistics.mean(c[0] for c in ref["counts"]),
        n_gated=statistics.mean(c[1] for c in ref["counts"]),
        density_ranks=tuple(int(r) for r in t["density_components"]),
        app_ranks=tuple(int(r) for r in t["color_components"]),
        app_dim=int(sh["app_dim"]), head_layers=tuple(layers.values()),
        planes=tuple(ref["planes"]), lines=tuple(ref["lines"]),
        n_params=int(ref["n_params"]), blur_taps=tuple(ref["blur_taps"]))
