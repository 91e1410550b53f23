"""PyTorch port vs JAX: the LLFF side of the NDC route.

* the llff, t2 and iphone loaders on tiny scenes written here (images,
  poses, intrinsics and near / far equal; the images at atol 1e-5, the
  resize being the port's own matmul form of jax.image.resize), and
  load_dataset's dispatch;
* the ray strategies: all_view_rand_grid, all_view_rand_rays and
  single_view_rand_rays, picked by their switch iterations, draw the same
  views and pixels from rng_np as JAX's trainer and leave it in the same
  state;
* the trainer on the facing scene with configs/bat_llff_VM_MLP.yaml's
  options (NDC, MLP_Fea_WeakView, relu, setbg_opaque false, TV, the
  n_rays switch, reset_pose_on_iter, warmup_pose, pin_first_pose, both
  strategy switches, an upsample), each step from JAX's state with JAX's
  jitter and coin: loss at rtol 1e-4, the pose table within 3 x lr_pose
  (zero at the reset, view 0's unmoved), the TV weights, the pose lr,
  the step's choices (no budget, the dense grid) and rng_np after every
  step and update;
* test-time pose optimisation under NDC with a rising
  optim.test_kernel_schedule (the LLFF test-kernel blur) and the
  background coin, fed JAX's draws: the refined pose at atol 1e-5, the
  final loss at rtol 1e-4;
* a WeakView / relu checkpoint both ways (every leaf, the TV weights);
* check_ported accepts the L2G and LLFF configs, soft_edge_mask and
  sync_2d_3d_scales, and still refuses, by name, the values the port does
  not run.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data import iphone as jiphone
from joint_tensorf_tpu.data import llff as jllff
from joint_tensorf_tpu.data import t2 as jt2
from joint_tensorf_tpu.data.base import SceneData as JSceneData
from joint_tensorf_tpu.pose.test_optim import \
    make_test_time_optimizer as jmake_optimizer
from joint_tensorf_tpu.render.renderer import BlurSpec as JBlurSpec
from joint_tensorf_tpu.render.renderer import RenderConfig as JRenderConfig
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import to_numpy, train_state_from_numpy
from joint_tensorf_tpu_torch.data import load_dataset, synthetic
from joint_tensorf_tpu_torch.pose.test_optim import (blur_of_test_kernel,
                                                     make_test_time_optimizer,
                                                     render_config)
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train.trainer import Trainer, check_ported
from joint_tensorf_tpu_torch.utils import setup_torch

imageio = pytest.importorskip("imageio.v2")
setup_torch()

CFG = "configs/bat_llff_VM_MLP.yaml"
SMALL = ["--data.dataset=synthetic", "--data.scene=facing",
         "--data.image_size=[12,16]", "--data.n_views=4",
         "--train_schedule.n_voxel_init=1000",
         "--train_schedule.n_voxel_final=3375", "--nerf.sample_intvs=24",
         "--train_schedule.n_rays_init=64", "--train_schedule.n_rays_rest=32",
         "--train_schedule.change_n_rays_after_n_iters=3",
         "--train_schedule.upsample_iters=[2]",
         "--train_schedule.update_alphamask_iters=[100]",
         "--train_schedule.reset_pose_on_iter=1",
         "--train_schedule.change_AccumPoseGrad_after_n_iters=4",
         "--train_schedule.n_AccumPoseGrad_init=2",
         "--train_schedule.pin_first_pose=true", "--optim.warmup_pose=3",
         "--c2f_kernel_size=4", "--blur_2d_c2f_kernel_size=5",
         "--max_iter=10", "--camera.noise=0.02",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=5", "--arch.shading.mlp_hidden_dim=8",
         "--+train_schedule.all_view_sample_after_n_iters=3",
         "--+train_schedule.single_view_sample_after_n_iters=5",
         "--tpu.densify_min_samples_per_chip=1000"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jscene(sc):
    return JSceneData(images=sc.images, poses=sc.poses, intr=sc.intr,
                      intr_inv=sc.intr_inv, near_far=sc.near_far, H=sc.H,
                      W=sc.W)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


# ------------------------------------------------------------ the loaders
@pytest.fixture(scope="module")
def disk_scenes(tmp_path_factory):
    """An LLFF, a t2 and an iPhone scene of 5 small frames each."""
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(1)
    (root / "llff" / "fern" / "images").mkdir(parents=True)
    (root / "t2" / "Ballroom" / "images").mkdir(parents=True)
    (root / "iphone" / "seq1").mkdir(parents=True)
    rows, log = [], []
    for i in range(5):
        c2w = np.eye(3, 4, dtype=np.float32)
        c2w[:3, :3] = _rot_x(0.05 * i)
        c2w[:3, 3] = [0.02 * i, 0.01, 0.1 * i]
        stored = c2w.copy()
        stored[:, 0], stored[:, 1] = -c2w[:, 1], c2w[:, 0]
        hwf = np.array([[12], [16], [20.0]], np.float32)
        rows.append(np.concatenate([np.concatenate([stored, hwf], 1).ravel(),
                                    [2.0 + i * 0.1, 6.0]]))
        log.append(f"{i} {i} 0")
        log += [" ".join(str(float(x)) for x in r) for r in c2w]
        log.append("0.0 0.0 0.0 1.0")
        for sub, name in (("llff/fern/images", f"im_{i}.png"),
                          ("t2/Ballroom/images", f"{i:06d}.png"),
                          ("iphone/seq1", f"f{i}.png")):
            imageio.imwrite(str(root / sub / name), rng.integers(
                0, 255, (12, 16, 3), dtype=np.uint8))
    np.save(str(root / "llff" / "fern" / "poses_bounds.npy"),
            np.stack(rows).astype(np.float32))
    (root / "t2" / "Ballroom" / "Ballroom_COLMAP_SfM.log").write_text(
        "\n".join(log) + "\n")
    return root


@pytest.mark.parametrize("name,scene,jmod", [
    ("llff", "fern", jllff), ("t2", "Ballroom", jt2),
    ("iphone", "seq1", jiphone)])
def test_disk_loaders_match_jax(disk_scenes, name, scene, jmod):
    args = [f"--data.root={disk_scenes / name}", f"--data.scene={scene}",
            "--data.image_size=[6,8]", "--data.val_ratio=0.2",
            f"--data.dataset={name}"]
    for split in (("train", "val") if name != "iphone" else ("train",)):
        want = jmod.load(jset_options(CFG, args), split)
        got = load_dataset(set_options(CFG, args), split)
        np.testing.assert_allclose(got.images, want.images, atol=1e-5)
        for k in ("poses", "intr", "intr_inv"):
            np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                       atol=1e-6, err_msg=f"{name} {k}")
        assert got.near_far == want.near_far and got.H == 6 and got.W == 8
    assert got.n_views == (5 if name == "iphone" else 1)


# ------------------------------------------------------------ strategies
@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(n_views=4, H=12, W=16, kind="facing",
                                near=0.0, far=1.0, device="cpu")


@pytest.mark.parametrize("it", [0, 3, 5], ids=["grid", "all_view_rays",
                                               "single_view_rays"])
def test_ray_strategies_match_jax(scene, it):
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(scene))
    pt = Trainer(set_options(CFG, SMALL), scene, device="cpu")
    jt.it = pt.it = it
    strat = pt._strategy()
    assert strat == jt._strategy() == ("all_view_rand_grid",
                                       "all_view_rand_rays",
                                       "single_view_rand_rays")[
        [0, 3, 5].index(it)]
    for _ in range(2):
        jv, ji, jg = jt._sample_rays(strat, jt._n_rays())
        pv, pi, pg = pt._sample_rays(strat, pt._n_rays())
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pi, ji)
        assert pg == jg
    assert pt.rng_np.bit_generator.state == jt.rng_np.bit_generator.state


# ------------------------------------------------------------ the trainer
def test_ndc_trainer_matches_jax(scene):
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(scene))
    pt = Trainer(set_options(CFG, SMALL), scene, device="cpu")
    assert jt.n_samples == pt.n_samples and pt.ndc
    se3 = jnp.asarray(np.random.default_rng(2).normal(size=(4, 6)) * 0.01,
                      jnp.float32)
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, se3_refine=se3))
    pt.state, pt.pose_base = train_state_from_numpy(
        flatten_train_state(jt.state, jt.pose_base), pt.vm_cfg)
    strategies, dense = set(), set()
    for it in range(6):
        pt.state, _ = train_state_from_numpy(flatten_train_state(jt.state),
                                             pt.vm_cfg)
        before = np.asarray(jt.state.params.se3_refine)
        _, step_key = jax.random.split(jt.key)
        rng_samp, rng_bg = jax.random.split(step_key)
        strat = pt._strategy()
        strategies.add(strat)
        rng_copy = np.random.default_rng()
        rng_copy.bit_generator.state = pt.rng_np.bit_generator.state
        pt_probe = pt.rng_np
        pt.rng_np = rng_copy
        view_sel, ray_idx, _ = pt._sample_rays(strat, pt._n_rays())
        pt.rng_np = pt_probe
        n = len(view_sel) * len(ray_idx)
        jitter = torch.as_tensor(np.array(jax.random.uniform(
            rng_samp, (n, pt.n_samples))))
        coin = bool(jax.random.uniform(rng_bg, ()) < 0.5)
        assert pt._lr_pose() == pytest.approx(jt._lr_pose(), rel=1e-12)
        jm = jt.train_iteration()
        pm = pt.train_iteration(jitter=jitter, bg_coin=coin)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"it {it}")
        cfg = pt.last_step_config
        assert cfg.ndc and not cfg.white_bg and cfg.pin_first_pose
        assert cfg.compact_k is None and cfg.densify_density == \
            jt._step_cfg.densify_density
        dense.add(cfg.densify_density)
        p_se3 = pt.state.se3_refine.detach().numpy()
        j_se3 = np.asarray(jt.state.params.se3_refine)
        np.testing.assert_allclose(p_se3, j_se3, atol=3e-3,
                                   err_msg=f"it {it}")
        if it == 1:                                   # the reset
            assert np.abs(before).max() > 0
            np.testing.assert_array_equal(p_se3[0], 0.0)
        np.testing.assert_array_equal(p_se3[0], j_se3[0])
        jt._update_schedule()
        pt._update_schedule()
        assert pt.tv_density_weight == pytest.approx(jt.tv_density_weight,
                                                     rel=1e-12)
        assert pt.tv_color_weight == pytest.approx(jt.tv_color_weight,
                                                   rel=1e-12)
        assert pt.rng_np.bit_generator.state == \
            jt.rng_np.bit_generator.state, it
        assert pt.resolution == jt.resolution and \
            pt.n_samples == jt.n_samples
        assert pt.compact_k_bbox is None and pt.compact_k_blur is None
        jt.it += 1
        pt.it += 1
    assert strategies == {"all_view_rand_grid", "all_view_rand_rays",
                          "single_view_rand_rays"}
    assert dense == {True, False}    # the grid, then one view's rays


# ------------------------------------------------------------ test time
def test_test_time_ndc_blur_matches_jax(scene):
    opt_args = SMALL + ["--data.dataset=llff",
                        "--optim.test_kernel_schedule=[0.0,0.3]"]
    popt = set_options(CFG, opt_args)
    blur, sched = blur_of_test_kernel(popt)
    assert blur is not None and sched == [0.0, 0.3]
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(scene))
    pt = Trainer(set_options(CFG, SMALL), scene, device="cpu")
    pt.state, pt.pose_base = train_state_from_numpy(
        flatten_train_state(jt.state, jt.pose_base), pt.vm_cfg)
    H, W, n_rays, n_iter = 12, 16, 20, 4
    S = pt.n_samples
    jrcfg = JRenderConfig(n_samples=S, is_train=True, white_bg=False,
                          ndc=True, stop_coord_grad=False)
    j_opt = jmake_optimizer(jt.vm_cfg, jrcfg, jt.head, H, W, n_rays=n_rays,
                            test_iter=n_iter, lr_init=1e-3, lr_end=1e-4,
                            blur=JBlurSpec("uniform-gaussian", 4),
                            test_kernel_schedule=sched, ndc=True)
    p_opt = make_test_time_optimizer(
        pt.vm_cfg, render_config(pt), H, W, n_rays=n_rays, test_iter=n_iter,
        lr_init=1e-3, lr_end=1e-4, blur=blur_of_test_kernel(set_options(
            CFG, opt_args))[0], test_kernel_schedule=sched)
    assert render_config(pt).ndc and not render_config(pt).white_bg
    images = scene.images.reshape(4, 3, -1).transpose(0, 2, 1)
    near_far = (0.2, 1.0)
    key = jax.random.PRNGKey(7)
    draws, k = [], key
    for _ in range(n_iter):
        k, sub = jax.random.split(k)
        idx = jax.random.permutation(jax.random.fold_in(sub, 0), H * W)[
            :n_rays]
        rs, rb = jax.random.split(sub)
        draws.append((torch.as_tensor(np.asarray(idx), dtype=torch.long),
                      torch.as_tensor(np.asarray(jax.random.uniform(
                          rs, (n_rays, S)))),
                      bool(jax.random.uniform(rb, ()) < 0.5)))
    j_pose, j_loss = j_opt(jt.state.params.field, None,
                           jnp.asarray(scene.poses[1]),
                           jnp.asarray(images[1]), jnp.asarray(scene.intr[1]),
                           jnp.asarray(scene.intr_inv[1]),
                           jnp.asarray(near_far, jnp.float32), key)
    p_pose, p_loss = p_opt(pt.state.field, None,
                           torch.as_tensor(scene.poses[1]),
                           torch.as_tensor(images[1]),
                           torch.as_tensor(scene.intr_inv[1]), near_far,
                           draws=lambda it: draws[it],
                           intr=torch.as_tensor(scene.intr[1]))
    np.testing.assert_allclose(p_pose.numpy(), np.asarray(j_pose), atol=1e-5)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
    assert float(np.abs(p_pose.numpy() - scene.poses[1]).max()) > 1e-5


# ------------------------------------------------------------ checkpoints
def test_weakview_checkpoint_both_ways(scene, tmp_path):
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(scene))
    jt.it = 3
    jt.tv_density_weight, jt.tv_color_weight = 7.5, 2.5
    path = str(tmp_path / "jax.ckpt.npz")
    jckpt.save_checkpoint(path, jt)
    assert any("['layer3']" in k for k in np.load(path).files)
    pt = Trainer(set_options(CFG, SMALL), scene, device="cpu")
    ckpt.restore_checkpoint(path, pt)
    want = flatten_train_state(jt.state)
    got = to_numpy(pt.state)
    for k in ("layer1", "layer2", "layer3"):
        for wb in ("w", "b"):
            np.testing.assert_array_equal(got["shading"][k][wb],
                                          want["shading"][k][wb])
            np.testing.assert_array_equal(
                got["scene_opt"]["mu"]["shading"][k][wb],
                want["scene_opt"]["mu"]["shading"][k][wb])
    np.testing.assert_array_equal(got["density_planes"][1],
                                  want["density_planes"][1])
    assert (pt.tv_density_weight, pt.tv_color_weight) == (7.5, 2.5)
    back = str(tmp_path / "port.ckpt.npz")
    ckpt.save_checkpoint(back, pt)
    assert sorted(k for k in np.load(back).files if k.startswith("state/")) \
        == sorted(k for k in np.load(path).files if k.startswith("state/"))
    jt2 = JTrainer(jset_options(CFG, SMALL), _jscene(scene))
    jckpt.restore_checkpoint(back, jt2)
    for k in ("layer1", "layer3"):
        np.testing.assert_array_equal(
            np.asarray(jt2.state.params.field.shading[k]["w"]),
            want["shading"][k]["w"])
    assert (jt2.tv_density_weight, jt2.it) == (7.5, 3)


# ------------------------------------------------------------ check_ported
@pytest.mark.parametrize("cfg", [
    "l2g_bat_blender_VM", "l2g_synthetic_convergence", "bat_llff_VM_MLP",
    "bat_synthetic_llff", "bat_synthetic_llff_parallax"])
def test_check_ported_accepts_l2g_and_llff_configs(cfg):
    check_ported(set_options(f"configs/{cfg}.yaml", []))


@pytest.mark.parametrize("override", [
    "--arch.feature_to_density_activation=exp",
    "--nerf.ray_sampling_strategy=single_view_rand_grid",
    "--tpu.mesh_shape=[16]",
    "--model=barf"])
def test_check_ported_still_refuses_by_name(override):
    key = override.split("=")[0].lstrip("-+")
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_ported(set_options(CFG, SMALL + [override]))


@pytest.mark.parametrize("override", ["--soft_edge_mask=true",
                                      "--+sync_2d_3d_scales=true"])
def test_check_ported_accepts_edge_and_scale_options(override):
    check_ported(set_options(CFG, SMALL + [override]))
