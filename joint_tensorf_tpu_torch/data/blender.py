"""Blender (NeRF-synthetic) scene loader
(counterpart of joint_tensorf_tpu/data/blender.py).

The focal comes from camera_angle_x at the raw 800x800; RGBA images are
composited over opt.data.bgcolor; each raw camera-to-world pose is flipped
by diag(1, -1, -1) and inverted to a world->cam [3, 4].  Reading the PNGs
needs ``imageio``, imported when a scene is loaded.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .base import SceneData, resize_images, scale_intrinsics

RAW_H, RAW_W = 800, 800


def _parse_raw_camera(pose_raw: np.ndarray) -> np.ndarray:
    """[4, 4] raw camera-to-world -> [3, 4] world->cam."""
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    R = flip @ pose_raw[:3, :3]
    t = flip @ pose_raw[:3, 3]
    R_inv = R.T
    t_inv = -R_inv @ t
    out = np.concatenate([R_inv, t_inv[:, None]], axis=1).astype(np.float32)
    if np.isnan(out).any():
        raise ValueError("a Blender camera matrix gave NaN")
    return out


def load(opt, split: str = "train", subset: int | None = None) -> SceneData:
    root = opt.data.get("root") or "data/blender"
    path = os.path.join(root, opt.data.scene)
    with open(os.path.join(path, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if subset:
        frames = frames[:subset]
    focal = 0.5 * RAW_W / np.tan(0.5 * meta["camera_angle_x"])

    import imageio.v2 as imageio

    images, poses = [], []
    bg = opt.data.get("bgcolor", 1)
    for f in frames:
        img = imageio.imread(os.path.join(path, f["file_path"] + ".png"))
        img = img.astype(np.float32) / 255.0                  # [H, W, 4]
        rgb, mask = img[..., :3], img[..., 3:]
        if bg is not None:
            rgb = rgb * mask + bg * (1 - mask)
        images.append(rgb.transpose(2, 0, 1))                 # [3, H, W]
        poses.append(_parse_raw_camera(np.asarray(f["transform_matrix"],
                                                  dtype=np.float32)))
    images = np.stack(images)
    poses = np.stack(poses)

    H, W = opt.data.image_size
    images = resize_images(images, (H, W))
    intr = np.array([[focal, 0, RAW_W / 2], [0, focal, RAW_H / 2], [0, 0, 1]],
                    dtype=np.float32)
    intr = scale_intrinsics(intr, (RAW_H, RAW_W), (H, W),
                            opt.data.get("center_crop"))
    intr = np.broadcast_to(intr, (len(frames), 3, 3)).copy()
    intr_inv = np.linalg.inv(intr).astype(np.float32)

    near, far = opt.nerf.depth.range
    return SceneData(images=images, poses=poses, intr=intr, intr_inv=intr_inv,
                     near_far=(float(near), float(far)), H=H, W=W)
