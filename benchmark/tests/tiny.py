"""A checkout of the benchmark whose two configurations are cut to a size
the CPU runs in seconds (16 x 16 images, 4 views, 16^3 -> 32^3 voxels,
S 64, 64 rays, schedules of 50 and 400 iterations), for the CPU tests:
the same cells, traffic mixes, readers and limits."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

COMMON = {"data.image_size": [16, 16], "data.n_views": 4,
          "train_schedule.n_voxel_init": 4096,
          "train_schedule.n_voxel_final": 32768, "c2f_kernel_size": 8,
          "blur_2d_c2f_kernel_size": 15, "freq.scalar": 4,
          "nerf.sample_intvs": 64, "tpu.densify_min_samples_per_chip": 1000,
          "tpu.mask_cap_voxels": 8000,
          "train_schedule.n_rays_init": 64}
TINY = {
    "bat_blender": dict(COMMON, **{
        "max_iter": 50,
        "train_schedule.upsample_iters": [2, 8],
        "train_schedule.update_alphamask_iters": [12, 16],
        "train_schedule.n_rays_rest": 64, "edge_mask_before_iter": 30,
        "train_schedule.change_AccumPoseGrad_after_n_iters": 10}),
    "bat_llff": dict(COMMON, **{
        "max_iter": 400,
        "train_schedule.upsample_iters": [6, 8],
        "train_schedule.update_alphamask_iters": [7],
        "train_schedule.n_rays_rest": 32, "nerf.n_rays": 32,
        "train_schedule.change_n_rays_after_n_iters": 6,
        "train_schedule.change_AccumPoseGrad_after_n_iters": 8,
        "train_schedule.reset_pose_on_iter": 3, "optim.warmup_pose": 2}),
}


def set_dotted(d: dict, dotted: str, value):
    parts = dotted.split(".")
    for p in parts[:-1]:
        d = d[p]
    d[parts[-1]] = value


def make_tiny_root(dst: str) -> str:
    """A copy of BENCHMARK.json and benchmark/ under ``dst`` with the
    configurations cut to TINY; returns ``dst``."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in TINY.items():
        path = os.path.join(dst, "benchmark", "configs", name + ".json")
        with open(path) as f:
            cfg = json.load(f)
        for k, v in over.items():
            set_dotted(cfg["options"], k, v)
        with open(path, "w") as f:
            json.dump(cfg, f)
    return dst
