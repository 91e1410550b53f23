"""What a run hands to both the program and the reference and every model
shares, made by the benchmark: the scene's images and cameras (scene.py)
and the pose noise.  Both come from the configuration's data.seed, the
same for every run, so that every run of a cell has the same occupancy and
so the same sample budgets, and probes with the same rays.  What comes from
``--seed`` (a model's weights) is the model's: models/<model>.py
``make_inputs``."""
from __future__ import annotations

import torch

from . import scene as scene_lib


def _kind_seed(options: dict) -> tuple:
    d = options["data"]
    return str(d.get("scene") or "blobs"), int(d.get("seed") or 0)


def scene(options: dict, device) -> dict:
    """The training split (scene.make_scene): images [V, 3, H, W] on the
    device, GT poses, intrinsics and their inverses."""
    d = options["data"]
    H, W = (int(s) for s in d["image_size"])
    kind, seed = _kind_seed(options)
    return scene_lib.make_scene(kind, int(d["n_views"]), H, W, seed, device)


def scene_field(options: dict):
    """The scene's analytic field: its objects' centres and sizes."""
    return scene_lib.scene_field(*_kind_seed(options))


def pose_noise(options: dict, device):
    """camera.noise x N(0, 1) of se(3) a view [V, 6] from data.seed + 1 on
    the device, or None without camera.noise."""
    noise = options.get("camera", {}).get("noise")
    if not noise:
        return None
    d = options["data"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(d.get("seed") or 0) + 1)
    return torch.randn((int(d["n_views"]), 6), generator=gen,
                       device=device) * float(noise)
