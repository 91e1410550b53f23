"""PyTorch port vs JAX: the training slice as a whole.

* Three train steps of the port against three of JAX make_train_step on a
  tiny BAT configuration (blur on, pose optimisation on, no compaction,
  no dense grid, dense appearance), from converted state with the same
  rays, jitter and scalars.  Loss and PSNR each step at rtol 1e-4; step-1
  gradients per leaf at rtol 1e-4 / atol 1e-4 of each leaf's largest
  entry; se3_refine after step 3 at atol 1e-5 (its gradients are sums
  over all rays, far from zero).  Adam turns a near-zero factor gradient
  into a +-lr update whose sign can flip with summation order, so factor
  parameters after step 3 are compared at atol 3*lr_index (basis and
  shading at 3*lr_basis), and nearly all of them must agree to 1e-4.
* The procedural scene against JAX make_scene (atol 1e-5).
* The trainer's host schedule (2D/3D blur scale draws, ray indices,
  learning rates, edge scalars, blurred targets and edge masks) against
  the JAX trainer's numpy draws, and a CPU smoke run of the port trainer.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import field_leaves, flatten_field, flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data import synthetic as jsynthetic
from joint_tensorf_tpu.data.base import SceneData as JSceneData
from joint_tensorf_tpu.geometry import lie as jlie, poses as jposes
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.render.renderer import BlurSpec as JBlurSpec
from joint_tensorf_tpu.train import step as jstep
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import to_numpy, train_state_from_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.models.vm import VMConfig
from joint_tensorf_tpu_torch.ops import cuda_build
from joint_tensorf_tpu_torch.render.renderer import BlurSpec
from joint_tensorf_tpu_torch.train import step as pstep
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

V, H, W, R = 3, 12, 12, 24
RES = (10, 10, 10)
LR_INDEX, LR_BASIS, LR_POSE = 0.02, 1e-3, 1e-3


def _scalars(i):
    return dict(lr_index=LR_INDEX, lr_basis=LR_BASIS, lr_pose=LR_POSE,
                c2f_density=0.1 * (i + 1), c2f_color=0.25,
                l1_weight=8e-5, use_edge=float(i % 2 == 0), edge_factor=1.5,
                non_edge_factor=0.5, view_pe_progress=1.0,
                fea_pe_progress=1.0, pose_do_step=1.0)


def test_three_train_steps_match_jax():
    jcfg = jvm.VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                        app_dim=6, hidden=8)
    pcfg = VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                    app_dim=6, hidden=8)
    n_samples = 34
    rng = np.random.default_rng(0)
    jts = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, RES,
                                 [-1.5] * 3 + [1.5] * 3, V)
    f = jts.params.field
    f.density_planes = [p * 8.0 for p in f.density_planes]
    f.density_lines = [l * 8.0 for l in f.density_lines]
    gt = jsynthetic.sphere_poses(V)
    noise = (rng.standard_normal((V, 6)) * 0.05).astype(np.float32)
    pose_base = np.asarray(jposes.compose([jlie.se3_to_SE3(noise), gt]))
    focal = 1.1 * W
    intr = np.broadcast_to(np.array(
        [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32),
        (V, 3, 3)).copy()
    intr_inv = np.linalg.inv(intr).astype(np.float32)
    images = rng.random((V, H * W, 3)).astype(np.float32)
    edges = (rng.random((V, H * W)) > 0.7).astype(np.float32)

    captured = {}

    def capture(vg):
        def wrapped(*a):
            out = vg(*a)
            captured["grads"] = out[1]
            return out
        return wrapped

    jcfg_step = jstep.StepConfig(
        H=H, W=W, n_views=V, rays_per_view=R, n_samples=n_samples,
        pose_opt=True, use_pose_noise=True,
        blur=JBlurSpec("uniform-gaussian", 8))
    jfn = jstep.make_train_step(jcfg_step, jcfg, jcfg.shading_head(),
                                jit=False, vg_transform=capture)
    pcfg_step = pstep.StepConfig(H=H, W=W, n_views=V, rays_per_view=R,
                                 n_samples=n_samples,
                                 blur=BlurSpec("uniform-gaussian", 8))
    pts, pbase = train_state_from_numpy(flatten_train_state(jts, pose_base),
                                        pcfg)
    t = torch.as_tensor
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        ray_idx = rng.permutation(H * W)[:R]
        view_sel = np.arange(V)
        s = _scalars(i)
        js = jstep.StepScalars(
            near_far=jnp.array([2.0, 6.0]), tv_density_weight=jnp.float32(0),
            tv_color_weight=jnp.float32(0), tv_depth_weight=jnp.float32(0),
            **{k: jnp.float32(v) for k, v in s.items()})
        jts, jm = jfn(jts, jnp.asarray(pose_base), jnp.asarray(intr),
                      jnp.asarray(intr_inv), jnp.asarray(images),
                      jnp.asarray(edges), jnp.asarray(view_sel),
                      jnp.asarray(ray_idx), key, js, None)
        jitter = np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                               (V * R, 1)))
        pm, pgrads = pstep.train_step(
            pts, pcfg_step, pcfg, pbase, t(intr_inv), t(images), t(edges),
            t(view_sel), t(ray_idx), pstep.StepScalars(**s),
            jitter=t(jitter))
        for k in ("loss", "psnr", "mse"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            want = field_leaves(flatten_field(captured["grads"].field))
            want["se3_refine"] = np.asarray(captured["grads"].se3_refine)
            assert set(pgrads) == set(want)
            for k in want:
                scale = float(np.abs(want[k]).max())
                np.testing.assert_allclose(
                    pgrads[k].numpy(), want[k], rtol=1e-4,
                    atol=1e-4 * scale + 1e-12, err_msg=f"grad {k}")
            assert np.abs(want["se3_refine"]).max() > 0

    got = to_numpy(pts)
    want = flatten_train_state(jts)
    np.testing.assert_allclose(got["se3_refine"], want["se3_refine"],
                               atol=1e-5)
    assert got["scene_opt"]["count"] == want["scene_opt"]["count"] == 3
    gl, wl = field_leaves(got), field_leaves(want)
    for k in wl:
        lr = LR_INDEX if k.split(".")[0].endswith(("planes", "lines")) \
            else LR_BASIS
        np.testing.assert_allclose(gl[k], wl[k], atol=3 * lr, err_msg=k)
        assert np.mean(np.abs(gl[k] - wl[k]) > 1e-4) < 0.01, k


def test_synthetic_scene_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("JTF_SCENE_CACHE", str(tmp_path))
    want = jsynthetic.make_scene(n_views=4, H=16, W=16, seed=0)
    got = synthetic.make_scene(n_views=4, H=16, W=16, seed=0, device="cpu")
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.intr_inv, want.intr_inv)
    assert got.near_far == want.near_far
    np.testing.assert_allclose(got.images, want.images, atol=1e-5)


SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=100",
         "--train_schedule.upsample_iters=[8]",
         "--tpu.bbox_compact=false", "--tpu.densify_density=false",
         "--tpu.app_k=null", "--tpu.blur_mask_compact=false"]
CFG = "configs/bat_blender_VM.yaml"


@pytest.fixture(scope="module")
def small_scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def test_host_schedule_matches_jax_trainer(small_scene):
    sc = small_scene
    jt = JTrainer(jset_options(CFG, SMALL), JSceneData(
        images=sc.images, poses=sc.poses, intr=sc.intr,
        intr_inv=sc.intr_inv, near_far=sc.near_far, H=sc.H, W=sc.W))
    pt = Trainer(set_options(CFG, SMALL), sc, device="cpu")
    for it in range(6):
        if getattr(jt, "_blur_cache_at", None) != (it // 500) * 500:
            jt._refresh_blur_cache()
            jt._blur_cache_at = (it // 500) * 500
        c2f_d, c2f_c, sc2d = jt._c2f_params()
        use_edge, ef, nef = jt._edge_scalars()
        assert jt._strategy() == "all_view_rand_grid"
        view_sel, ray_idx, grid_hw = jt._sample_rays(jt._strategy(),
                                                     jt._n_rays())
        want = dict(c2f_density=c2f_d, c2f_color=c2f_c, use_edge=use_edge,
                    edge_factor=ef, non_edge_factor=nef,
                    lr_index=jt.lr_index, lr_basis=jt.lr_basis,
                    lr_pose=jt._lr_pose(), l1_weight=jt._l1_weight(),
                    near_far=tuple(jt._near_far()))
        s, blur_spec, p_view, p_idx, p_grid, p_sc2d = pt.host_schedule()
        for k, v in want.items():
            assert getattr(s, k) == pytest.approx(v, rel=1e-12), (it, k)
        assert p_sc2d == sc2d
        assert (blur_spec is None) == (jt._blur_spec(c2f_d, c2f_c) is None)
        np.testing.assert_array_equal(p_view, view_sel)
        np.testing.assert_array_equal(p_idx, ray_idx)
        assert p_grid == grid_hw
        if it == 0:
            assert set(pt.blurred_images) == set(jt.blurred_images)
            for key in jt.blurred_images:
                np.testing.assert_allclose(
                    pt.blurred_images[key].numpy(),
                    np.asarray(jt.blurred_images[key]), atol=1e-5)
                np.testing.assert_array_equal(
                    pt.edge_masks[key].numpy(),
                    np.asarray(jt.edge_masks[key]))
        jt._update_schedule()
        pt._update_schedule()
        jt.it += 1
        pt.it += 1


def test_cpu_smoke_run_stops_at_the_upsample(small_scene):
    """run(max_iter=8) trains the first phase and stops before iteration 8,
    whose schedule update is the upsample (upsample_iters=[8])."""
    pt = Trainer(set_options(CFG, SMALL + ["--freq.scalar=2"]), small_scene,
                 device="cpu")
    se3_0 = pt.state.se3_refine.detach().clone()
    res0 = pt.resolution
    cuda_build.reset_launches()
    hist = pt.run(max_iter=8, log_every=2)
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert not torch.equal(pt.state.se3_refine.detach(), se3_0)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())  # plain path
    assert pt.it == 8 and pt.resolution == res0
    assert pt.state.scene_opt.count == 8


def test_cpu_smoke_run_crosses_the_upsample(small_scene):
    """Past the upsample after iteration 8, which earlier slices stopped
    at, the run goes on at the new resolution with fresh field moments."""
    pt = Trainer(set_options(CFG, SMALL + ["--freq.scalar=2"]), small_scene,
                 device="cpu")
    res0 = pt.resolution
    hist = pt.run(max_iter=10, log_every=1)
    assert len(hist) == 10 and all(np.isfinite(h["loss"]) for h in hist)
    assert pt.resolution != res0
    assert pt.state.scene_opt.count == 1      # rebuilt after iteration 8
    assert pt.state.pose_opt.count == 10      # the pose optimiser is kept


@pytest.mark.parametrize("override", ["--model=barf",
                                      "--tpu.mesh_shape=[16]",
                                      "--tpu.densify_impl=blocked",
                                      "--tpu.factor_dtype=float16"])
def test_unported_options_raise(small_scene, override):
    # the rays and comp layouts of a mesh run (tests/test_torch_parallel.py,
    # tests/test_torch_parallel_comp.py): an axis of another name is what
    # stays refused
    extra = ["--tpu.mesh_axes=[heads]"] if "mesh_shape" in override else []
    with pytest.raises(NotImplementedError, match=override.split("=")[0][2:]):
        Trainer(set_options(CFG, SMALL + [override] + extra), small_scene,
                device="cpu")


def test_entry_points_default_to_the_card(small_scene):
    """Without a device argument the port runs on CUDA and raises where
    there is none: it never falls back to the CPU by itself."""
    from joint_tensorf_tpu_torch.utils.torch_setup import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(set_options(CFG, SMALL), small_scene)
