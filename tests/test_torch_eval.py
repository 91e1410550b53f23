"""PyTorch port vs JAX: evaluation.

* geometry/align.py and lie.rotation_distance on seeded noisy poses:
  prealign_cameras, align_test_pose, evaluate_camera_alignment at 1e-6
  (radians and translation);
* metrics/quality.py: psnr and ssim on seeded images, [C,H,W] and [H,W,C],
  at 1e-6;
* Trainer.render_views on one JAX trainer state carried into the port
  (density in one box, so the mask is selective and the eval budget
  compacts): with the mask (compaction) and without it (the dense grid),
  with tpu.eval_app_k unset and set; rgb within 1e-5 of max|rgb|, opacity
  within 5e-5, equal eval budgets;
* eval_clip_stats' dict equal to JAX's, with the numpy generator's state
  equal after it; validate's PSNR within 1e-4; pose_error within 1e-5;
* evaluation does not move training: a port run that validates (and
  measures the pose error) at every log point trains bit for bit like one
  that does not, and its numpy generator ends in the same state.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data.base import SceneData as JSceneData
from joint_tensorf_tpu.geometry import align as jalign
from joint_tensorf_tpu.geometry import lie as jlie
from joint_tensorf_tpu.geometry import poses as jposes
from joint_tensorf_tpu.metrics import quality as jquality
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import train_state_from_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.geometry import align, lie
from joint_tensorf_tpu_torch.metrics import quality
from joint_tensorf_tpu_torch.models.alpha_mask import AlphaMask
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

CFG = "configs/bat_blender_VM.yaml"
# 62^3 voxels: S = 214, even, so the mask-stride-2 group compaction runs;
# no shrink, so S stays above the 128 floor of the eval budget
SMALL = ["--data.dataset=synthetic", "--data.image_size=[32,32]",
         "--data.n_views=6", "--data.val_sub=2",
         "--train_schedule.n_voxel_init=238328",
         "--train_schedule.n_voxel_final=262144",
         "--train_schedule.n_rays_init=192", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=20",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--train_schedule.upsample_iters=[10]",
         "--train_schedule.update_alphamask_iters=[12]",
         "--train_schedule.shrink_bbox_with_alphamask=false"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and a pool per worker oversubscribes them (the
    trainer's many small ops then wait on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jscene(sc):
    return JSceneData(images=sc.images, poses=sc.poses, intr=sc.intr,
                      intr_inv=sc.intr_inv, near_far=sc.near_far, H=sc.H,
                      W=sc.W)


def _box_field(field, rng):
    """The JAX field with density factors positive only over the box of
    fractions [0.35, 0.65] of every axis (and a fresh field's appearance)."""
    res = field.resolution()
    inside = [(np.arange(r) / (r - 1) >= 0.35) & (np.arange(r) / (r - 1)
                                                  <= 0.65) for r in res]
    planes, lines = [], []
    for i in range(3):
        m0, m1 = jvm.MAT_MODE[i]
        p = rng.uniform(0.5, 1.0, (res[m1], res[m0], 3)).astype(np.float32)
        planes.append(jnp.asarray(
            p * (inside[m1][:, None] & inside[m0][None, :])[..., None] * 4.0))
        ax = jvm.VEC_MODE[i]
        l = rng.uniform(0.5, 1.0, (res[ax], 3)).astype(np.float32)
        lines.append(jnp.asarray(l * inside[ax][:, None]))
    return dataclasses.replace(field, density_planes=planes,
                               density_lines=lines)


def carry_to_port(jt, pt):
    """The JAX trainer's state, pose base, shapes, mask and numpy
    generator into the port trainer."""
    pt.state, pt.pose_base = train_state_from_numpy(
        flatten_train_state(jt.state, jt.pose_base), pt.vm_cfg)
    pt.resolution = list(jt.resolution)
    pt.n_samples = jt.n_samples
    pt.alphamask_resolution = list(jt.alphamask_resolution)
    pt.alpha_mask = None if jt.alpha_mask is None else AlphaMask(
        grid=torch.as_tensor(np.asarray(jt.alpha_mask.grid)),
        aabb=torch.as_tensor(np.asarray(jt.alpha_mask.aabb)))
    pt.rng_np.bit_generator.state = jt.rng_np.bit_generator.state


@pytest.fixture(scope="module")
def trainers():
    """A JAX trainer with a box of density, a random pose refinement and
    its mask built (no shrink), and the port trainer carrying its state."""
    sc = synthetic.make_scene(n_views=6, H=32, W=32, device="cpu")
    val = synthetic.make_scene(n_views=2, H=32, W=32, pose_seed=1000,
                               device="cpu")
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(sc), _jscene(val))
    assert jt.resolution == [62, 62, 62] and jt.n_samples == 214
    rng = np.random.default_rng(0)
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, field=_box_field(jt.state.params.field, rng),
        se3_refine=jnp.asarray(rng.normal(size=(6, 6)) * 0.01,
                               jnp.float32)))
    jt._update_alphamask(12)
    assert jt.alpha_mask is not None and jt.compact_k is not None
    pt = Trainer(set_options(CFG, SMALL), sc, val, device="cpu")
    carry_to_port(jt, pt)
    return jt, pt, val


def _noisy_poses(seed):
    gt = synthetic.sphere_poses(8, seed=seed)
    noise = np.random.default_rng(seed).normal(size=(8, 6)) * 0.15
    pose = np.array(jposes.compose([jlie.se3_to_SE3(
        jnp.asarray(noise, jnp.float32)), jnp.asarray(gt)]))
    return pose, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_align_matches_jax(seed):
    pose, gt = _noisy_poses(seed)
    a_j, sim_j = jalign.prealign_cameras(jnp.asarray(pose), jnp.asarray(gt))
    a_p, sim_p = align.prealign_cameras(torch.as_tensor(pose),
                                        torch.as_tensor(gt))
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), atol=1e-6)
    np.testing.assert_allclose(sim_p.R, sim_j.R, atol=1e-6)
    test_gt = synthetic.sphere_poses(3, seed=seed + 1000)
    np.testing.assert_allclose(
        align.align_test_pose(torch.as_tensor(test_gt), sim_p).numpy(),
        np.asarray(jalign.align_test_pose(jnp.asarray(test_gt), sim_j)),
        atol=1e-6)
    r_j, t_j = jalign.evaluate_camera_alignment(a_j, jnp.asarray(gt))
    r_p, t_p = align.evaluate_camera_alignment(a_p, torch.as_tensor(gt))
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), atol=1e-6)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=1e-6)
    np.testing.assert_allclose(
        lie.rotation_distance(torch.as_tensor(pose[:, :, :3]),
                              torch.as_tensor(gt[:, :, :3])).numpy(),
        np.asarray(jlie.rotation_distance(jnp.asarray(pose[:, :, :3]),
                                          jnp.asarray(gt[:, :, :3]))),
        atol=1e-6)


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_quality_matches_jax(layout):
    rng = np.random.default_rng(3)
    shape = (3, 24, 20) if layout == "chw" else (24, 20, 3)
    target = rng.uniform(size=shape).astype(np.float32)
    pred = np.clip(target + rng.normal(size=shape) * 0.1, 0, 1).astype(
        np.float32)
    p, t = torch.as_tensor(pred), torch.as_tensor(target)
    np.testing.assert_allclose(
        float(quality.psnr(p, t)),
        float(jquality.psnr(jnp.asarray(pred), jnp.asarray(target))),
        atol=1e-6)
    np.testing.assert_allclose(
        float(quality.ssim(p, t)),
        float(jquality.ssim(jnp.asarray(pred), jnp.asarray(target))),
        atol=1e-6)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("eval_app_k", [None, 32], ids=["dense_app",
                                                        "eval_app_k"])
def test_render_views_matches_jax(trainers, masked, eval_app_k):
    jt, pt, val = trainers
    j_mask, p_mask = jt.alpha_mask, pt.alpha_mask
    if not masked:
        jt.alpha_mask = pt.alpha_mask = None
    jt.opt.tpu.eval_app_k = pt.opt.tpu.eval_app_k = eval_app_k
    try:
        pose = val.poses[:1]
        j_out = jt.render_views(jnp.asarray(pose), jnp.asarray(val.intr[:1]),
                                jnp.asarray(val.intr_inv[:1]))
        p_out = pt.render_views(torch.as_tensor(pose), val.intr[:1],
                                torch.as_tensor(val.intr_inv[:1]))
        j_k = jt._probe_compact_k(poses=jnp.asarray(pose),
                                  intr_inv=jnp.asarray(val.intr_inv[:1]),
                                  pad=1.5)
    finally:
        jt.alpha_mask, pt.alpha_mask = j_mask, p_mask
        jt.opt.tpu.eval_app_k = pt.opt.tpu.eval_app_k = None
    cfg = pt.last_eval_config
    assert cfg.compact_k == j_k
    if masked:
        assert cfg.compact_k is not None and cfg.compact_k < cfg.n_samples
        assert not cfg.densify_density
    else:
        assert cfg.compact_k is None and cfg.densify_density
    assert cfg.app_k == eval_app_k
    rgb_j = np.asarray(j_out[0])
    scale = float(np.abs(rgb_j).max())
    np.testing.assert_allclose(p_out[0].numpy(), rgb_j, atol=1e-5 * scale)
    # opacity sums S weights: float32 cumulative-product rounding
    np.testing.assert_allclose(p_out[2].numpy(), np.asarray(j_out[2]),
                               atol=5e-5)


def test_clip_stats_validate_pose_error_match_jax(trainers):
    jt, pt, val = trainers
    pose = val.poses
    clip_j = jt.eval_clip_stats(jnp.asarray(pose), jnp.asarray(val.intr_inv))
    clip_p = pt.eval_clip_stats(torch.as_tensor(pose),
                                torch.as_tensor(val.intr_inv))
    assert clip_p == clip_j
    assert clip_p["compact_k"] is not None
    assert pt.rng_np.bit_generator.state == jt.rng_np.bit_generator.state
    v_j, v_p = jt.validate(), pt.validate()
    np.testing.assert_allclose(v_p["psnr"], v_j["psnr"], atol=1e-4)
    e_j, e_p = jt.pose_error(), pt.pose_error()
    for k in ("rot_deg", "trans"):
        np.testing.assert_allclose(e_p[k], e_j[k], atol=1e-5)
    assert pt.rng_np.bit_generator.state == jt.rng_np.bit_generator.state


def test_evaluation_does_not_move_training():
    """The CLI's evaluation at log points (validate, pose_error) leaves the
    training draws and the trained state as they were."""
    args = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
            "--data.n_views=4", "--data.val_sub=2",
            "--train_schedule.n_voxel_init=4096",
            "--train_schedule.n_voxel_final=32768",
            "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
            "--blur_2d_c2f_kernel_size=15", "--max_iter=12",
            "--train_schedule.upsample_iters=[2,4]",
            "--train_schedule.update_alphamask_iters=[5]"]
    opt = set_options(CFG, args)
    sc = synthetic.load(opt, "train", device="cpu")
    val = synthetic.load(opt, "val", device="cpu")
    runs = []
    for evaluate in (False, True):
        pt = Trainer(set_options(CFG, args), sc, val, device="cpu")
        seen = []

        def on_log(tr, m):
            v = tr.validate()
            seen.append((v["psnr"], tr.pose_error()["rot_deg"]))

        pt.run(log_every=3, callback=on_log if evaluate else None)
        runs.append(pt)
        if evaluate:
            assert len(seen) == 4 and all(np.isfinite(seen).ravel())
    a, b = runs
    assert a.alpha_mask is not None
    assert a.rng_np.bit_generator.state == b.rng_np.bit_generator.state
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    pa, pb = (dict(t.state.field.named_parameters()) for t in runs)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(a.state.se3_refine, b.state.se3_refine)
