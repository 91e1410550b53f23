"""PyTorch port vs JAX: the Blender loader and its base helpers.

No Blender data ships with the repository, so each test writes a 3-frame
scene of 32x32 RGBA PNGs (imageio) with transforms_{train,test}.json to
tmp_path; the focal comes from camera_angle_x at the raw 800 pixels, as
for the real scenes.  Both loaders must agree within 1e-6 on poses and
intrinsics, and within 1e-5 on images at a resize that downsamples (JAX's
antialiased bilinear) and at one that keeps the size.
"""
import json
import os

import numpy as np
import pytest

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data import base as jbase
from joint_tensorf_tpu.data import load_dataset as jload_dataset
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.data import base, load_dataset


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _write_scene(root, rng, n=3, hw=32):
    import imageio.v2 as imageio

    scene = os.path.join(root, "toy")
    os.makedirs(os.path.join(scene, "train"))
    for split in ("train", "test"):
        frames = []
        for i in range(n):
            rgba = rng.integers(0, 256, (hw, hw, 4), dtype=np.uint8)
            rgba[: hw // 4, :, 3] = 0            # fully transparent rows
            name = f"train/{split}_{i}"
            imageio.imwrite(os.path.join(scene, name + ".png"), rgba)
            c2w = np.eye(4)
            c2w[:3, :3] = _rotation(rng)
            c2w[:3, 3] = rng.normal(size=3) * 4.0
            frames.append({"file_path": name,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618,
                       "frames": frames}, f)


@pytest.mark.parametrize("size,split,bg", [
    ([16, 16], "train", 1), ([32, 32], "test", 1), ([20, 12], "train", 0)])
def test_blender_load_matches_jax(tmp_path, size, split, bg):
    _write_scene(str(tmp_path), np.random.default_rng(3))
    args = ["--data.dataset=blender", f"--data.root={tmp_path}",
            "--data.scene=toy", f"--data.image_size={size}",
            f"--data.bgcolor={bg}"]
    yaml = "configs/tensorf_blender_VM.yaml"
    want = jload_dataset(jset_options(yaml, args), split)
    got = load_dataset(set_options(yaml, args), split)
    assert (got.H, got.W) == tuple(size) and got.n_views == 3
    assert got.near_far == want.near_far
    for k in ("poses", "intr", "intr_inv"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert got.images.shape == want.images.shape == (3, 3, *size)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-5)


def test_blender_subset(tmp_path):
    _write_scene(str(tmp_path), np.random.default_rng(4))
    opt = set_options("configs/tensorf_blender_VM.yaml", [
        f"--data.root={tmp_path}", "--data.scene=toy",
        "--data.image_size=[8,8]"])
    assert load_dataset(opt, "train", subset=2).n_views == 2


@pytest.mark.parametrize("crop", [None, 0.75])
def test_scale_intrinsics_matches_jax(crop):
    intr = np.array([[1111.1, 0, 400], [0, 1111.1, 400], [0, 0, 1]],
                    np.float32)
    want = jbase.scale_intrinsics(intr, (800, 800), (300, 200), crop)
    got = base.scale_intrinsics(intr, (800, 800), (300, 200), crop)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,target", [((32, 32), (16, 16)),
                                       ((30, 40), (17, 23)),
                                       ((16, 16), (32, 24)),
                                       ((9, 9), (9, 9))])
def test_resize_matches_jax(hw, target):
    x = np.random.default_rng(0).random((2, 3, *hw)).astype(np.float32)
    np.testing.assert_allclose(base.resize_images(x, target),
                               jbase.resize_images(x, target),
                               rtol=0, atol=1e-6)
