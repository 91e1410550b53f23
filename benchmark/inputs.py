"""The inputs a run hands to both the program and the reference, made by
the benchmark: the scene's images and cameras (scene.py; the scene is the
configuration's, data.seed, the same for every run so that every seed has
the same occupancy and so the same sample budgets), and from ``--seed`` the
field's weights at the initial resolution (one torch.Generator on the
device, two large draws), the warm start that gives them the scene's
occupancy, and the pose noise."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import scene as scene_lib
from .census.frozen import warm_start_density
from .reference import field as ref_field
from .reference.step import FACTORS, Inputs, resolution


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


def make(options: dict, seed: int, start_it: int, device,
         warm_radii: float) -> Inputs:
    """The run's inputs.  ``warm_radii`` > 0: the warm start over boxes of
    +-warm_radii object radii (0: none).  The pose noise, like the scene,
    comes from data.seed: it moves the probe rays, so that every run
    probes the same budgets."""
    d = options["data"]
    H, W = (int(s) for s in d["image_size"])
    kind = str(d.get("scene") or "blobs")
    scene = scene_lib.make_scene(kind, int(d["n_views"]), H, W,
                                 int(d.get("seed") or 0), device)
    weights = make_weights(options, seed, device)
    if warm_radii:
        field = scene_lib.scene_field(kind, int(d.get("seed") or 0))
        sizes = field.radii if hasattr(field, "radii") else field.sizes
        aabb = np.asarray(d["scene_bbox"], np.float64).reshape(2, 3)
        res = resolution(np.asarray(d["scene_bbox"], np.float32).reshape(
            2, 3).astype(np.float64), int(options["train_schedule"][
                "n_voxel_init"]))
        warm_start_density(weights, field.centers, sizes, aabb, res,
                           warm_radii)
    noise = options.get("camera", {}).get("noise")
    noise_se3 = None
    if noise:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(d.get("seed") or 0) + 1)
        noise_se3 = torch.randn((int(d["n_views"]), 6), generator=gen,
                                device=device) * float(noise)
    return Inputs(opt=options, images=scene["images"], poses=scene["poses"],
                  intr=scene["intr"], intr_inv=scene["intr_inv"],
                  weights=weights, noise_se3=noise_se3, seed=int(seed),
                  start_it=int(start_it))
