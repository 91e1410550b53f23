"""PyTorch port vs JAX: viz/, the pose-gradient maps and the CLIs' last
options, on the CPU at small sizes, the same numpy inputs on both sides.

* novel_view_poses, novel_view_around_bbox, delta_pose,
  angle_to_rotation_matrix, make's defaults and world2cam at atol 1e-6;
* Trainer.visualize_pose_gradient on one JAX state carried into the port
  (12x12 pixels in chunks of 64, so the last chunk pads), each map within
  1e-4 of its largest entry; the alpha mask is ignored on both sides;
* write_video's three outcomes (the video, PNG frames, frames.npz)
  byte-equal to JAX's files; depth_to_inv_vis and _camera_frustum equal;
* generate_pose_video from the port's snapshots for the VM trainer and
  BarfTrainer (tests/test_engines.py:96-118 of the JAX side);
* run_cli strips --pdb and opens pdb.post_mortem on an exception;
  MetricLogger.log_image into a stand-in writer;
* soft_edge_mask, and the trainer's edge masks at every scale with it;
* sync_2d_3d_scales: 20 iterations of the blur scales and the host
  generator's state afterwards, equal to the JAX trainer's;
* generate_augmentation / apply_color_jitter and the quaternion functions.
"""
import dataclasses
import os
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import (_box_field, _jscene, carry_to_port,  # noqa: F401
                             one_torch_thread)

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data import base as jbase
from joint_tensorf_tpu.geometry import poses as jposes
from joint_tensorf_tpu.geometry import quaternion as jquat
from joint_tensorf_tpu.models.alpha_mask import AlphaMask as JAlphaMask
from joint_tensorf_tpu.ops import sobel as jsobel
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu.utils import cli as jcli
from joint_tensorf_tpu.viz import grad_viz as jgrad
from joint_tensorf_tpu.viz import novel_views as jnovel
from joint_tensorf_tpu.viz import poses_plot as jplot
from joint_tensorf_tpu.viz import video as jvideo
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.data import base, synthetic
from joint_tensorf_tpu_torch.geometry import poses, quaternion
from joint_tensorf_tpu_torch.models.alpha_mask import AlphaMask
from joint_tensorf_tpu_torch.ops import sobel
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import cli
from joint_tensorf_tpu_torch.utils.logging import MetricLogger
from joint_tensorf_tpu_torch.viz import (grad_viz, novel_views, pose_video,
                                         poses_plot, video)

CFG = "configs/bat_blender_VM.yaml"


def _pose(seed, n=None):
    """Seeded world->cam poses (a rotation from a random quaternion)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n or 1, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jquat.q_to_R(jnp.asarray(q, jnp.float32)))
    t = rng.normal(size=(n or 1, 3, 1)).astype(np.float32)
    p = np.concatenate([R, t], -1).astype(np.float32)
    return p if n else p[0]


# ------------------------------------------------------------ trajectories
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_novel_view_poses_match_jax(scale):
    anchor = _pose(0)
    want = jnovel.novel_view_poses(jnp.asarray(anchor), n=12, scale=scale)
    got = novel_views.novel_view_poses(torch.as_tensor(anchor), n=12,
                                       scale=scale)
    assert got.shape == (12, 3, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("bbox", [[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
                                  [-1.5, -1.67, -2.0, 1.5, 1.67, 1.0]])
def test_novel_view_around_bbox_matches_jax(bbox):
    want = jnovel.novel_view_around_bbox(bbox, n=24, scale=1.2)
    got = novel_views.novel_view_around_bbox(bbox, n=24, scale=1.2,
                                             device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("axis", ["X", "Y", "Z"])
def test_angle_to_rotation_matrix_matches_jax(axis):
    a = np.random.default_rng(1).uniform(-3, 3, (5, 2)).astype(np.float32)
    want = jposes.angle_to_rotation_matrix(jnp.asarray(a), axis)
    got = poses.angle_to_rotation_matrix(torch.as_tensor(a), axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_delta_pose_matches_jax():
    d = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32)
    got = grad_viz.delta_pose(torch.as_tensor(d))              # batched
    for i in range(4):
        want = np.asarray(jgrad.delta_pose(jnp.asarray(d[i])))
        np.testing.assert_allclose(grad_viz.delta_pose(
            torch.as_tensor(d[i])).numpy(), want, atol=1e-6)
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(
        grad_viz.delta_pose(torch.zeros(6)).numpy(),
        np.concatenate([np.eye(3), np.zeros((3, 1))], -1))


def test_make_defaults_and_world2cam_match_jax():
    rng = np.random.default_rng(3)
    R = _pose(4, n=3)[..., :3]
    t = rng.normal(size=(3, 3)).astype(np.float32)
    for kw in ({"R": R}, {"t": t}, {"R": R, "t": t}):
        np.testing.assert_array_equal(
            poses.make(**{k: torch.as_tensor(v) for k, v in kw.items()}
                       ).numpy(),
            np.asarray(jposes.make(**{k: jnp.asarray(v)
                                      for k, v in kw.items()})))
    X = rng.normal(size=(3, 7, 3)).astype(np.float32)
    p = _pose(5, n=3)
    np.testing.assert_allclose(
        poses.world2cam(torch.as_tensor(X), torch.as_tensor(p)).numpy(),
        np.asarray(jposes.world2cam(jnp.asarray(X), jnp.asarray(p))),
        atol=1e-6)


# ------------------------------------------------------ pose-gradient maps
GRAD_SMALL = ["--data.dataset=synthetic", "--data.image_size=[12,12]",
              "--data.n_views=3", "--train_schedule.n_voxel_init=32768",
              "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
              "--blur_2d_c2f_kernel_size=15",
              "--arch.tensorf.density_components=[3,3,3]",
              "--arch.tensorf.color_components=[4,4,4]",
              "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8"]


def test_visualize_pose_gradient_matches_jax():
    """144 pixels in chunks of 64: the last chunk wraps to pixels 0-47,
    which are cut off again.  An alpha mask that keeps a third of the
    cells is set on both trainers: neither renders through it."""
    sc = synthetic.make_scene(n_views=3, H=12, W=12, device="cpu")
    jt = JTrainer(jset_options(CFG, GRAD_SMALL), _jscene(sc))
    rng = np.random.default_rng(0)
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, field=_box_field(jt.state.params.field, rng),
        se3_refine=jnp.asarray(rng.normal(size=(3, 6)) * 0.01,
                               jnp.float32)))
    grid = (rng.random(jt.resolution) > 0.66).astype(np.float32)
    aabb = np.asarray(jt.state.params.field.aabb)
    jt.alpha_mask = JAlphaMask(grid=jnp.asarray(grid),
                               aabb=jnp.asarray(aabb))
    pt = Trainer(set_options(CFG, GRAD_SMALL), sc, device="cpu")
    carry_to_port(jt, pt)
    pt.alpha_mask = AlphaMask(grid=torch.as_tensor(grid),
                              aabb=torch.as_tensor(aabb))
    flags = [p.requires_grad for p in pt.state.field.parameters()]
    want = jt.visualize_pose_gradient(view=1, n_rays_chunk=64)
    chunks = []
    got = pt.visualize_pose_gradient(view=1, n_rays_chunk=64,
                                     on_chunk=chunks.append)
    assert chunks == [0, 1, 2]
    for g, w, name in zip(got, want, ("rot", "trans")):
        w = np.asarray(w)
        assert g.shape == w.shape == (3, 12, 12)
        assert np.abs(w).max() > 0
        for c in range(3):
            np.testing.assert_allclose(g[c], w[c],
                                       atol=1e-4 * np.abs(w[c]).max(),
                                       err_msg=f"{name}[{c}]")
    # the field is unfrozen again afterwards
    assert [p.requires_grad for p in pt.state.field.parameters()] == flags
    assert all(flags)


# ------------------------------------------------------------------ videos
def _frames(n=3, H=6, W=8):
    rng = np.random.default_rng(4)
    return [rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
            for _ in range(n)]


def _fake_imageio(monkeypatch, outcome):
    """imageio as the outcome needs it: a writer that works (writes the
    raw frames), one without a video backend, or none at all."""
    if outcome == "npz":
        monkeypatch.setitem(sys.modules, "imageio", None)
        monkeypatch.setitem(sys.modules, "imageio.v2", None)
        return
    import imageio.v2 as real

    def mimwrite(path, frames, fps):
        if outcome == "png":
            raise RuntimeError("no backend for .mp4")
        with open(path, "wb") as f:
            f.write(f"{fps}".encode() + np.stack(frames).tobytes())

    v2 = types.SimpleNamespace(mimwrite=mimwrite, imwrite=real.imwrite,
                               imread=real.imread)
    monkeypatch.setitem(sys.modules, "imageio",
                        types.SimpleNamespace(v2=v2))
    monkeypatch.setitem(sys.modules, "imageio.v2", v2)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("outcome,written", [
    ("mp4", ["v.mp4"]),
    ("png", ["v_frames/0000.png", "v_frames/0001.png", "v_frames/0002.png"]),
    ("npz", ["v_frames/frames.npz"])])
def test_write_video_outcomes_equal_jax(tmp_path, monkeypatch, outcome,
                                        written):
    _fake_imageio(monkeypatch, outcome)
    # the zip entries of frames.npz carry the clock's time: hold it
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    paths = {}
    for side, fn in (("jax", jvideo.write_video), ("port", video.write_video)):
        os.makedirs(tmp_path / side)
        paths[side] = fn(str(tmp_path / side / "v.mp4"), _frames(), fps=7)
    assert os.path.basename(paths["port"]) == os.path.basename(paths["jax"])
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(written)
    assert got == want


def test_depth_to_inv_vis_and_frustum_equal_jax():
    rng = np.random.default_rng(5)
    depth = rng.uniform(2, 6, (9, 7)).astype(np.float32)
    opacity = rng.uniform(0, 1, (9, 7)).astype(np.float32)
    np.testing.assert_array_equal(video.depth_to_inv_vis(depth, opacity),
                                  jvideo.depth_to_inv_vis(depth, opacity))
    p = _pose(6)
    np.testing.assert_array_equal(poses_plot._camera_frustum(p, 0.3),
                                  jplot._camera_frustum(p, 0.3))


TINY_VM = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
           "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
           "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
           "--blur_2d_c2f_kernel_size=15"]
TINY_BARF = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
             "--data.n_views=4", "--nerf.sample_intvs=16",
             "--nerf.n_rays=64", "--max_iter=10"]


@pytest.mark.parametrize("kind", ["vm", "barf"])
def test_pose_video_from_snapshots(tmp_path, kind):
    from joint_tensorf_tpu_torch.train import checkpoint as ckpt
    from joint_tensorf_tpu_torch.train.barf_trainer import BarfTrainer

    if kind == "vm":
        opt = set_options(CFG, TINY_VM)
        tr = Trainer(opt, synthetic.load(opt, "train", device="cpu"),
                     device="cpu")
        save, restore = ckpt.save_checkpoint, ckpt.restore_checkpoint
    else:
        opt = set_options("configs/barf_blender.yaml", TINY_BARF)
        tr = BarfTrainer(opt, synthetic.load(opt, "train", device="cpu"),
                         device="cpu")
        save = ckpt.save_simple_checkpoint
        restore = ckpt.restore_simple_checkpoint
    out_dir = str(tmp_path)
    assert pose_video.generate_pose_video(out_dir, tr, restore) is None
    for stop in (2, 4):
        tr.run(max_iter=stop, log_every=2)
        save(os.path.join(out_dir, f"model_it{stop}.ckpt.npz"), tr)
    tr.run(max_iter=6, log_every=2)
    assert pose_video._snapshot_paths(out_dir) == [
        (2, os.path.join(out_dir, "model_it2.ckpt.npz")),
        (4, os.path.join(out_dir, "model_it4.ckpt.npz"))]
    vid = pose_video.generate_pose_video(out_dir, tr, restore, fps=2)
    assert vid is not None and os.path.exists(vid)
    assert os.path.exists(os.path.join(out_dir, "poses", "2.png"))
    assert os.path.exists(os.path.join(out_dir, "poses", "4.png"))
    assert tr.it == 4          # left on the last snapshot


# -------------------------------------------------------- CLI and logging
def test_run_cli_strips_pdb(monkeypatch):
    seen, post = [], []
    monkeypatch.setattr("pdb.post_mortem", lambda: post.append(1))
    assert cli.run_cli(lambda a: seen.append(a) or 5,
                       ["--x=1", "--pdb", "--y"]) == 5
    assert seen == [["--x=1", "--y"]] and post == []

    def boom(argv):
        raise ValueError(f"bad {argv}")

    for mod in (cli, jcli):         # the port as JAX: traceback, pdb, raise
        with pytest.raises(ValueError, match=r"bad \['--z'\]"):
            mod.run_cli(boom, ["--pdb", "--z"])
    assert post == [1, 1]
    with pytest.raises(ValueError):
        cli.run_cli(boom, [])
    assert post == [1, 1]


def test_log_image_to_a_writer(tmp_path):
    class Writer:
        def __init__(self):
            self.images = []

        def add_image(self, tag, img, step):
            self.images.append((tag, img, step))

    logger = MetricLogger(str(tmp_path))
    img = torch.linspace(-0.5, 1.5, 4 * 5 * 3).reshape(4, 5, 3)
    logger.log_image("val_rgb", img, 7, split="val")     # no sink: nothing
    assert os.listdir(tmp_path) == []
    logger.tb = Writer()
    logger.log_image("val_rgb", img, 7, split="val")
    (tag, chw, step), = logger.tb.images
    assert (tag, step, chw.shape) == ("val/val_rgb", 7, (3, 4, 5))
    np.testing.assert_array_equal(
        chw, np.clip(img.numpy(), 0, 1).transpose(2, 0, 1))


# -------------------------------------------- soft edges, synced scales
def test_soft_edge_mask_matches_jax():
    imgs = np.random.default_rng(7).random((2, 3, 9, 11)).astype(np.float32)
    got = sobel.soft_edge_mask(torch.as_tensor(imgs)).numpy()
    want = np.asarray(jsobel.soft_edge_mask(jnp.asarray(imgs)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got.shape == (2, 99) and np.allclose(got.max(axis=1), 1.0)


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_trainer_edge_masks_match_jax(soft):
    args = TINY_VM + [f"--soft_edge_mask={str(soft).lower()}"]
    sc = synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")
    jt = JTrainer(jset_options(CFG, args), _jscene(sc))
    pt = Trainer(set_options(CFG, args), sc, device="cpu")
    # at progress 0.1 every scale but 0 blurs
    jt.it = pt.it = int(0.1 * pt.max_iter)
    jt._refresh_blur_cache()
    pt._refresh_blur_cache()
    assert sorted(pt.edge_masks) == sorted(jt.edge_masks) == \
        [0.0, 0.25, 0.5, 0.75, 1.0]
    for sc_ in jt.edge_masks:
        want = np.asarray(jt.edge_masks[sc_])
        got = pt.edge_masks[sc_].numpy()
        assert got.dtype == np.float32
        if soft:
            np.testing.assert_allclose(got, want, atol=1e-5)
            assert 0 < got.mean() < 1 and np.allclose(got.max(1), 1.0)
        else:
            np.testing.assert_array_equal(got, want)


def test_sync_2d_3d_scales_draws_as_jax():
    args = TINY_VM + ["--+sync_2d_3d_scales=true", "--max_iter=100"]
    sc = synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")
    jt = JTrainer(jset_options(CFG, args), _jscene(sc))
    pt = Trainer(set_options(CFG, args), sc, device="cpu")
    pt.rng_np.bit_generator.state = jt.rng_np.bit_generator.state
    seen = []
    for it in range(20):
        jt.it = pt.it = it
        want = jt._c2f_params()
        got = pt._c2f_params()
        assert got == want, it
        assert (got[0] == 0.0) == (got[2] == 0.0)      # one scale for both
        seen.append(got[2])
    assert len(set(seen)) > 2                      # the pool was drawn
    assert pt.rng_np.bit_generator.state == jt.rng_np.bit_generator.state
    assert pt._blur_sigma_max(10) == jt._blur_sigma_max(10)


# ------------------------------------------- augmentation, quaternions
def test_augmentation_matches_jax():
    args = ["--+data.augment.brightness=0.2", "--+data.augment.contrast=0.3",
            "--+data.augment.saturation=0.25", "--+data.augment.hue=0.1",
            "--+data.augment.hflip=true", "--+data.augment.rotate=15"]
    imgs = np.random.default_rng(8).random((2, 3, 5, 6)).astype(np.float32)
    for extra in ([], args):
        rng_p, rng_j = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(3):
            aug = base.generate_augmentation(set_options(CFG, extra), rng_p)
            assert aug == jbase.generate_augmentation(
                jset_options(CFG, extra), rng_j)
            np.testing.assert_array_equal(
                base.apply_color_jitter(imgs, aug),
                jbase.apply_color_jitter(imgs, aug))
        assert rng_p.bit_generator.state == rng_j.bit_generator.state
    assert aug["flip"] in (True, False) and aug["hue"] != 0


def test_quaternions_match_jax():
    rng = np.random.default_rng(10)
    q = rng.normal(size=(2, 8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tq, jq = torch.as_tensor(q), jnp.asarray(q)
    R = quaternion.q_to_R(tq)
    np.testing.assert_allclose(R.numpy(), np.asarray(jquat.q_to_R(jq)),
                               atol=1e-6)
    np.testing.assert_allclose(
        quaternion.R_to_q(R).numpy(),
        np.asarray(jquat.R_to_q(jnp.asarray(R.numpy()))), atol=1e-6)
    np.testing.assert_allclose(quaternion.invert(tq[0]).numpy(),
                               np.asarray(jquat.invert(jq[0])), atol=1e-6)
    np.testing.assert_allclose(
        quaternion.product(tq[0], tq[1]).numpy(),
        np.asarray(jquat.product(jq[0], jq[1])), atol=1e-6)
