"""BARF (bundle-adjusting coordinate-MLP NeRF) as the benchmark runs it: the
MLP's weights from the seed, the port's BarfTrainer
(joint_tensorf_tpu_torch/train/barf_trainer.py) at the cell's first
iteration, the plain reference (reference/barf.py) and the MLP census
(census/barf_counts.py).  The exports are those models/__init__.py
lists."""
from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs as inputs_lib
from benchmark.census import barf_counts as census
from benchmark.reference.barf import B1, Reference  # noqa: F401
from benchmark.reference.step import Inputs
from joint_tensorf_tpu_torch.config.options import Options
from joint_tensorf_tpu_torch.data.base import SceneData
from joint_tensorf_tpu_torch.geometry import lie, poses as pose_ops
from joint_tensorf_tpu_torch.train.barf_trainer import BarfTrainer


# ------------------------------------------------------------- the inputs
def layer_shapes(options: dict) -> dict:
    """{"mlp.<part>.<i>": (fan_in, fan_out)} of BARF's MLP: the feature
    layers on the encoded points (again at each skip), the last one with
    the density channel first, the RGB head on the features and the
    encoded view direction."""
    arch = options["arch"]
    pe = arch["posenc"]
    d3, dv = 3 + 6 * int(pe["L_3D"]), 3 + 6 * int(pe["L_view"])
    feat = [int(w) for w in arch["layers_feat"][1:]]
    skip = {int(s) for s in arch["skip"]}
    out, k_in = {}, d3
    for li, k_out in enumerate(feat):
        if li in skip:
            k_in += d3
        last = li == len(feat) - 1
        out[f"mlp.feat.{li}"] = (k_in, k_out + 1 if last else k_out)
        k_in = k_out
    for li, k_out in enumerate(int(w) for w in arch["layers_rgb"][1:]):
        out[f"mlp.rgb.{li}"] = (k_in + dv if li == 0 else k_in, k_out)
        k_in = k_out
    return out


def _xavier(fan_in: int, fan_out: int, gain: float) -> float:
    return gain * math.sqrt(6.0 / (fan_in + fan_out))


def make_weights(options: dict, seed: int, device) -> dict:
    """The MLP's weights by BARF's tf_init law (model/nerf.py
    tensorflow_init_weights: Xavier uniform with the relu gain sqrt(2), but
    gain 1 on the RGB output layer and on the density channel, which is
    drawn as a layer of its own), from one generator on the device seeded
    with ``seed``, in one call; biases zero."""
    shapes = layer_shapes(options)
    arch = options["arch"]
    density = f"mlp.feat.{len(arch['layers_feat']) - 2}"
    output = f"mlp.rgb.{len(arch['layers_rgb']) - 2}"
    relu = math.sqrt(2.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [i * o for i, o in shapes.values()]
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out = {}
    for (k, (i, o)), part in zip(shapes.items(), torch.split(uniform, sizes)):
        if k == output:
            bound = [_xavier(i, o, 1.0)] * o
        elif k == density:
            bound = [_xavier(i, 1, 1.0)] + [_xavier(i, o - 1, relu)] * (o - 1)
        else:
            bound = [_xavier(i, o, relu)] * o
        out[f"{k}.w"] = part.reshape(i, o) * torch.tensor(bound,
                                                          device=device)
        out[f"{k}.b"] = torch.zeros(o, device=device)
    return out


def make_inputs(options: dict, seed: int, start_it: int, device,
                warm_radii: float) -> Inputs:
    """The run's inputs: the scene (inputs.scene), the MLP's weights from
    ``seed`` and the pose noise (inputs.pose_noise).  BARF has no warm
    start: ``warm_radii`` must be 0."""
    if warm_radii:
        raise ValueError("BARF's MLP has no warm start: warm_radii must "
                         "be 0")
    scene = inputs_lib.scene(options, device)
    return Inputs(opt=options, images=scene["images"], poses=scene["poses"],
                  intr=scene["intr"], intr_inv=scene["intr_inv"],
                  weights=make_weights(options, seed, device),
                  noise_se3=inputs_lib.pose_noise(options, device),
                  seed=int(seed), start_it=int(start_it))


# ------------------------------------------------------------ the program
class SpanTrainer(BarfTrainer):
    """The BarfTrainer with a host span around each call of the step."""
    spans = False

    def _step(self, view_sel, ray_idx, draws):
        t0 = time.perf_counter()
        if self.spans:
            with record_function("bench.train_step"):
                out = super()._step(view_sel, ray_idx, draws)
        else:
            out = super()._step(view_sel, ray_idx, draws)
        self.step_s.append(time.perf_counter() - t0)
        return out


def params(trainer) -> dict:
    return dict(trainer.params)


def first_grad_norms(trainer) -> dict:
    """After the first step, the norm of each leaf's gradient as Adam
    received it: its first moment over 1 - b1 (the moments start at
    zero)."""
    return {k: torch.linalg.vector_norm(m) / (1 - B1)
            for k, m in trainer.opt_state.mu.items()}


@torch.no_grad()
def build(inputs: Inputs, device) -> SpanTrainer:
    """The BarfTrainer at the cell's first iteration: the benchmark's
    weights and pose noise installed, the iteration set (BARF's schedule
    is its learning rates and band weights, both read from it), its two
    generators seeded from the run's seed."""
    opt = Options(copy.deepcopy(inputs.opt))
    _, _, H, W = inputs.images.shape
    data = SceneData(images=inputs.images, poses=inputs.poses,
                     intr=inputs.intr, intr_inv=inputs.intr_inv,
                     near_far=tuple(float(v) for v in opt.nerf.depth.range),
                     H=H, W=W)
    trainer = SpanTrainer(opt, data, device=device)
    trainer.step_s = []
    mlp = {k: v for k, v in trainer.params.items() if k != "se3_refine"}
    if set(mlp) != set(inputs.weights):
        raise ValueError(f"the MLP's parameters {sorted(mlp)} are not the "
                         f"benchmark's {sorted(inputs.weights)}")
    for k, p in mlp.items():
        if tuple(p.shape) != tuple(inputs.weights[k].shape):
            raise ValueError(f"{k}: the MLP holds {tuple(p.shape)}, the "
                             f"benchmark {tuple(inputs.weights[k].shape)}")
        p.copy_(inputs.weights[k])
    if inputs.noise_se3 is not None:
        trainer.pose_noise = lie.se3_to_SE3(inputs.noise_se3.to(device))
        trainer.pose_base = pose_ops.compose([trainer.pose_noise,
                                              trainer.gt_poses])
    trainer.it = inputs.start_it
    trainer.rng_np = np.random.default_rng(inputs.seed)
    trainer.generator.manual_seed(inputs.seed)
    return trainer


def describe(trainer) -> str:
    # getattr: a BarfTrainer without the trainer contract has no
    # rays_per_step, and then fails where run() refuses on_step
    return (f"iteration {trainer.it}, progress {trainer.progress:.6f}, "
            f"rays {getattr(trainer, 'rays_per_step', None)} (last step) x S "
            f"{trainer.n_samples}, MLP feat {trainer.mlp_cfg.layers_feat} "
            f"skip {trainer.mlp_cfg.skip}, rgb {trainer.mlp_cfg.layers_rgb}, "
            f"L {trainer.mlp_cfg.L_3D} / {trainer.mlp_cfg.L_view}")


# ----------------------------------------------------------- the schedule
def start_iteration(options: dict, anchor: dict) -> int:
    """BARF has no schedule lists: a traffic mix starts at
    ``{"iteration": n}``."""
    return int(anchor["iteration"])


def schedule_moves(options: dict, start: int, n: int) -> list:
    """None: BARF's schedule changes no shape or function, only the
    learning rates and the band weights, which both sides read from the
    iteration."""
    return []


# ------------------------------------------------------------- the census
def step_shape(cell, ref: dict) -> census.StepShape:
    o = cell.config["options"]
    pe = o["arch"]["posenc"]
    return census.StepShape(
        n_rays=int(ref["rays"]), n_samples=int(ref["samples"]),
        layers=tuple(layer_shapes(o).values()),
        encoded=6 * int(pe["L_3D"]) + 6 * int(pe["L_view"]),
        n_params=int(ref["n_params"]))
