"""LLFF (forward-facing) scene loader
(counterpart of joint_tensorf_tpu/data/llff.py).

poses_bounds.npy [N, 17] parsing, the column swap (x <- y, y <- -x), the
scale 1 / (bounds.min() * 0.75), the re-orthonormalised pose centering,
the flip-invert-flip raw-pose conversion, and the last val_ratio fraction
of frames as the val / test split.  Reading the images needs ``imageio``,
imported when a scene is loaded.
"""
from __future__ import annotations

import os

import numpy as np

from .base import SceneData, resize_images, scale_intrinsics


def _normalize(v):
    return v / np.linalg.norm(v)


def _center_camera_poses(poses):
    """Poses relative to the re-orthonormalised average pose."""
    center = poses[..., 3].mean(axis=0)
    vz = _normalize(poses[..., 2].mean(axis=0))
    vy_hat = poses[..., 1].mean(axis=0)
    vx = _normalize(np.cross(vy_hat, vz))
    vy = np.cross(vz, vx)
    pose_avg = np.stack([vx, vy, vz, center], axis=-1)  # [3,4]

    # compose(poses, invert(pose_avg)): x -> inv(avg)(poses(x))
    R_avg, t_avg = pose_avg[:, :3], pose_avg[:, 3]
    R_inv = R_avg.T
    t_inv = -R_inv @ t_avg
    R_p, t_p = poses[..., :3], poses[..., 3]
    R_new = R_inv[None] @ R_p
    t_new = (R_inv[None] @ t_p[..., None])[..., 0] + t_inv
    return np.concatenate([R_new, t_new[..., None]], axis=-1)


def _parse_raw_camera(pose_raw):
    """flip o invert o flip."""
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    R = flip @ pose_raw[:3, :3]
    t = flip @ pose_raw[:3, 3]
    R_inv, t_inv = R.T, -R.T @ t
    R2 = flip @ R_inv
    t2 = flip @ t_inv
    return np.concatenate([R2, t2[:, None]], axis=1).astype(np.float32)


def load(opt, split: str = "train", subset: int | None = None) -> SceneData:
    root = opt.data.get("root") or "data/llff"
    path = os.path.join(root, opt.data.scene)
    img_dir = os.path.join(path, "images")
    fnames = sorted(os.listdir(img_dir))

    data = np.load(os.path.join(path, "poses_bounds.npy")).astype(np.float32)
    cam_data = data[:, :-2].reshape(-1, 3, 5)
    poses_raw = cam_data[..., :4].copy()
    # [R|t] column swap: x <- y, y <- -x
    c0 = poses_raw[..., 0].copy()
    poses_raw[..., 0] = poses_raw[..., 1]
    poses_raw[..., 1] = -c0
    raw_H, raw_W, focal = cam_data[0, :, -1]
    bounds = data[:, -2:]
    scale = 1.0 / (bounds.min() * 0.75)
    poses_raw[..., 3] *= scale
    bounds = bounds * scale
    poses_raw = _center_camera_poses(poses_raw)

    items = list(zip(fnames, poses_raw, bounds))
    num_val = int(len(items) * float(opt.data.get("val_ratio", 0.1)))
    # with a tiny dataset num_val can round to 0, which must not empty
    # the train split
    if split == "train":
        items = items[:-num_val] if num_val else items
    else:
        items = items[-num_val:] if num_val else items[-1:]
    if subset:
        items = items[:subset]

    import imageio.v2 as imageio

    H, W = opt.data.image_size
    images, poses = [], []
    for fname, p_raw, _ in items:
        img = imageio.imread(os.path.join(img_dir, fname)).astype(np.float32)
        img = (img / 255.0)[..., :3].transpose(2, 0, 1)
        images.append(resize_images(img[None], (H, W))[0])
        poses.append(_parse_raw_camera(p_raw))
    images = np.stack(images)
    poses = np.stack(poses)

    intr = np.array([[focal, 0, raw_W / 2], [0, focal, raw_H / 2], [0, 0, 1]],
                    dtype=np.float32)
    intr = scale_intrinsics(intr, (raw_H, raw_W), (H, W),
                            opt.data.get("center_crop"))
    intr = np.broadcast_to(intr, (len(items), 3, 3)).copy()
    intr_inv = np.linalg.inv(intr).astype(np.float32)

    near, far = opt.nerf.depth.range
    return SceneData(images=images, poses=poses, intr=intr, intr_inv=intr_inv,
                     near_far=(float(near), float(far)), H=H, W=W)
