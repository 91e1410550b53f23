"""Tanks & Temples scene loader, COLMAP SfM .log poses
(counterpart of joint_tensorf_tpu/data/t2.py).

5-line-per-camera .log parsing, the diag(-1, -1, 1) back-rotation, the
re-orthonormalised pose centering and the flip-invert-flip conversion
shared with LLFF, the last val_ratio frames as the val / test split.
Reading the images needs ``imageio``, imported when a scene is loaded.
"""
from __future__ import annotations

import os

import numpy as np

from .base import SceneData, resize_images, scale_intrinsics
from .llff import _center_camera_poses, _parse_raw_camera


def _parse_sfm_log(path: str) -> np.ndarray:
    """[N, 3, 4] camera-to-world rows from a COLMAP .log (the top 3 of
    each camera's 4)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() != ""]
    assert len(lines) % 5 == 0, "malformed COLMAP .log"
    poses = []
    i = 0
    while i < len(lines):
        i += 1  # image id line
        rows = []
        for _ in range(3):
            rows.append([float(x) for x in lines[i].split(" ")])
            i += 1
        i += 1  # the 0 0 0 1 row
        poses.append(rows)
    return np.asarray(poses, dtype=np.float32)  # [N, 3, 4]


def load(opt, split: str = "train", subset: int | None = None) -> SceneData:
    root = opt.data.get("root") or "data/t2"
    path = os.path.join(root, opt.data.scene)
    img_dir = os.path.join(path, "images")
    fnames = sorted(os.listdir(img_dir))

    log_files = [f for f in os.listdir(path) if f.endswith("_COLMAP_SfM.log")]
    assert log_files, f"no *_COLMAP_SfM.log under {path}"
    poses_raw = _parse_sfm_log(os.path.join(path, log_files[0]))

    # 180-degree back-rotation: R_new = R_flip @ R, t_new = R_flip @ t
    flip = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    R_new = flip[None] @ poses_raw[..., :3]
    t_new = (flip[None] @ poses_raw[..., 3:])
    poses_raw = np.concatenate([R_new, t_new], axis=-1)
    poses_raw = _center_camera_poses(poses_raw)

    items = list(zip(fnames, poses_raw))
    num_val = int(len(items) * float(opt.data.get("val_ratio", 0.1)))
    # same `[:-0]` tiny-dataset guard as llff.py
    if split == "train":
        items = items[:-num_val] if num_val else items
    else:
        items = items[-num_val:] if num_val else items[-1:]
    if subset:
        items = items[:subset]

    import imageio.v2 as imageio

    H, W = opt.data.image_size
    images, poses = [], []
    raw_hw = None
    for fname, p_raw in items:
        img = imageio.imread(os.path.join(img_dir, fname)).astype(np.float32)
        if raw_hw is None:
            raw_hw = img.shape[:2]
        img = (img / 255.0)[..., :3].transpose(2, 0, 1)
        images.append(resize_images(img[None], (H, W))[0])
        poses.append(_parse_raw_camera(p_raw))
    images = np.stack(images)
    poses = np.stack(poses)

    raw_h, raw_w = raw_hw
    focal = float(opt.data.get("focal", 0.7 * raw_w))
    intr = np.array([[focal, 0, raw_w / 2], [0, focal, raw_h / 2], [0, 0, 1]],
                    dtype=np.float32)
    intr = scale_intrinsics(intr, (raw_h, raw_w), (H, W),
                            opt.data.get("center_crop"))
    intr = np.broadcast_to(intr, (len(items), 3, 3)).copy()
    intr_inv = np.linalg.inv(intr).astype(np.float32)

    near, far = opt.nerf.depth.range
    return SceneData(images=images, poses=poses, intr=intr, intr_inv=intr_inv,
                     near_far=(float(near), float(far)), H=H, W=W)
