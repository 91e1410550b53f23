"""Custom-sequence (iPhone) loader (counterpart of
joint_tensorf_tpu/data/iphone.py): the poses are unknown and start at the
identity (pose optimisation recovers them); the focal comes from the
iPhone sensor model, raw_W * 4.2 mm / (12.8 mm / 2.55).  Reading the
images needs ``imageio``, imported when a scene is loaded."""
from __future__ import annotations

import os

import numpy as np

from .base import SceneData, resize_images, scale_intrinsics


def load(opt, split: str = "train", subset: int | None = None) -> SceneData:
    root = opt.data.get("root") or "data/iphone"
    path = os.path.join(root, str(opt.data.scene))
    img_dir = os.path.join(path, "images") if os.path.isdir(
        os.path.join(path, "images")) else path
    fnames = sorted(f for f in os.listdir(img_dir)
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if subset:
        fnames = fnames[:subset]

    import imageio.v2 as imageio

    H, W = opt.data.image_size
    images = []
    raw_hw = None
    for fname in fnames:
        img = imageio.imread(os.path.join(img_dir, fname)).astype(np.float32)
        if raw_hw is None:
            raw_hw = img.shape[:2]
        img = (img / 255.0)[..., :3].transpose(2, 0, 1)
        images.append(resize_images(img[None], (H, W))[0])
    images = np.stack(images)
    n = len(fnames)

    # identity dummy poses
    poses = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (n, 3, 4)).copy()

    raw_h, raw_w = raw_hw
    focal = raw_w * 4.2 / (12.8 / 2.55)
    intr = np.array([[focal, 0, raw_w / 2], [0, focal, raw_h / 2], [0, 0, 1]],
                    dtype=np.float32)
    intr = scale_intrinsics(intr, (raw_h, raw_w), (H, W),
                            opt.data.get("center_crop"))
    intr = np.broadcast_to(intr, (n, 3, 3)).copy()
    intr_inv = np.linalg.inv(intr).astype(np.float32)

    near, far = opt.nerf.depth.range
    return SceneData(images=images, poses=poses, intr=intr, intr_inv=intr_inv,
                     near_far=(float(near), float(far)), H=H, W=W)
