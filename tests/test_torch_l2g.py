"""PyTorch port vs JAX: L2G-BAT (train/l2g.py, train/l2g_trainer.py).

* rigid_points_registration: R, t and the gradients of a scalar of both
  against JAX's at random point sets (rtol 1e-4), a reflected point set
  (det +1 on both, equal values), and a point set whose exact covariance
  has two equal singular values (a centred 5 x 5 pixel grid of a square
  image): the gradients are finite on both sides (float32 rounding keeps
  the singular values apart), as JAX's;
* the warp MLP with skip_warp against warp_mlp_apply (atol 1e-6);
* sample_error_map_rays fed the uniforms of JAX's key splits (rng -> (rng,
  ks), ks -> (kg, kj)): the same pixels and cells;
* local_pose_and_rays for shared [R] and per-view [B, R] ray indices
  (atol 1e-5);
* one L2G step from a converted state, with the error map and the random
  background coin, at pose_do_step 1 and 0: loss at rtol 1e-4, the Adam
  moments (the gradients) at rtol 1e-3 of each leaf's max, the updated
  field and warp within 3 x lr (Adam turns near-zero gradients into +-lr
  steps whose sign depends on summation order), error map and optimised
  poses at atol 1e-5;
* l2g_depth_range;
* L2GTrainer and JAX's for 4 iterations across an upsample and a mask
  update, each step from JAX's state with JAX's draws: loss at rtol 1e-4,
  the budgets, the numpy generator, the error map and the registered
  poses after every step and schedule update;
* an L2G checkpoint both ways (every leaf equal, the schedule, the mask).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flatten_l2g_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data.base import SceneData as JSceneData
from joint_tensorf_tpu.geometry import align as jalign
from joint_tensorf_tpu.geometry import poses as jposes
from joint_tensorf_tpu.geometry.rays import camera_grid_3d as jcamera_grid
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train import l2g as jl2g
from joint_tensorf_tpu.train.l2g_trainer import L2GTrainer as JL2GTrainer
from joint_tensorf_tpu.train.step import StepConfig as JStepConfig
from joint_tensorf_tpu.train.step import default_scalars
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import l2g_state_from_numpy, l2g_to_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.geometry import align
from joint_tensorf_tpu_torch.geometry import poses as pposes
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train import l2g
from joint_tensorf_tpu_torch.train.l2g_trainer import L2GTrainer
from joint_tensorf_tpu_torch.train.step import StepConfig, StepScalars
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

CFG = "configs/l2g_bat_blender_VM.yaml"
SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
         "--train_schedule.n_voxel_final=13824",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=12",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--arch.embedding_dim=4", "--arch.layers_warp=[8,8,6]",
         "--arch.skip_warp=[1]", "--error_map_size=8",
         "--train_schedule.upsample_iters=[1]",
         "--train_schedule.update_alphamask_iters=[2]",
         "--train_schedule.shrink_bbox_with_alphamask=false"]
BUDGETS = ("compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def _jscene(sc):
    return JSceneData(images=sc.images, poses=sc.poses, intr=sc.intr,
                      intr_inv=sc.intr_inv, near_far=sc.near_far, H=sc.H,
                      W=sc.W)


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------ registration
@pytest.mark.parametrize("seed", [0, 1])
def test_rigid_points_registration_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 10, 3)).astype(np.float32)
    y = (x @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T
         + rng.normal(size=(3, 1, 3)) * 0.5
         + rng.normal(size=x.shape) * 0.05).astype(np.float32)
    a = rng.normal(size=(3, 3, 3)).astype(np.float32)
    b = rng.normal(size=(3, 3)).astype(np.float32)

    def jf(x, y):
        R, t = jalign.rigid_points_registration(x, y)
        return jnp.sum(R * a) + jnp.sum(t * b)

    (jR, jt_), (jgx, jgy) = (jalign.rigid_points_registration(x, y),
                             jax.grad(jf, argnums=(0, 1))(x, y))
    xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
    R, t = align.rigid_points_registration(xt, yt)
    gx, gy = torch.autograd.grad(torch.sum(R * _t(a)) + torch.sum(t * _t(b)),
                                 [xt, yt])
    np.testing.assert_allclose(R.detach().numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jt_),
                               atol=1e-5)
    for got, want in ((gx, jgx), (gy, jgy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
    assert np.allclose(np.linalg.det(R.detach().numpy()), 1.0, atol=1e-5)


def test_rigid_points_registration_reflection():
    """A mirrored point set: the best proper rotation, det +1, on both."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 12, 3)).astype(np.float32)
    y = (x * np.array([1, 1, -1], np.float32)).astype(np.float32)
    jR, jt_ = jalign.rigid_points_registration(x, y)
    R, t = align.rigid_points_registration(_t(x), _t(y))
    assert np.allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt_), atol=1e-5)


def test_registration_gradient_at_equal_singular_values():
    """A centred 5 x 5 grid of a square 15 x 15 image (fx = fy, cx = cy):
    the camera-frame covariance has two equal singular values.  The
    global-alignment loss of the exact rigid transform of it has finite
    gradients in JAX (float32 keeps the singular values apart), and in the
    port."""
    H = W = 15
    f = 1.1 * W
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    ii = jnp.asarray(np.linalg.inv(intr))[None]
    xs = np.array([1, 4, 7, 10, 13])
    gx, gy = np.meshgrid(xs, xs)
    cg = jcamera_grid(H, W, ii, ray_idx=jnp.asarray((gx + gy * W).ravel()))
    q = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    q[:, 2] *= np.sign(np.linalg.det(q))
    pose = np.concatenate([q, [[0.1], [0.2], [4.0]]], 1)[None].astype(
        np.float32)

    def jloss(delta):
        world = jposes.cam2world(cg, pose) + delta
        centers = jposes.cam2world(jnp.zeros_like(cg), pose)
        src = jnp.concatenate([cg, jnp.zeros_like(cg)], 1)
        tgt = jnp.concatenate([world, centers], 1)
        R, t = jalign.rigid_points_registration(tgt, src)
        return jnp.mean((tgt - jposes.cam2world(src, jposes.make(R=R, t=t)))
                        ** 2)

    g_j = np.asarray(jax.grad(jloss)(jnp.zeros_like(cg)))
    cgt, poset = _t(cg), _t(pose)
    delta = torch.zeros_like(cgt, requires_grad=True)
    world = pposes.cam2world(cgt, poset) + delta
    centers = pposes.cam2world(torch.zeros_like(cgt), poset)
    src = torch.cat([cgt, torch.zeros_like(cgt)], 1)
    tgt = torch.cat([world, centers], 1)
    R, t = align.rigid_points_registration(tgt, src)
    loss = torch.mean((tgt - pposes.cam2world(src, pposes.make(R, t))) ** 2)
    g_p, = torch.autograd.grad(loss, delta)
    s = np.linalg.svd(np.cov(np.asarray(src[0]).T))[1]
    assert abs(s[1] - s[2]) < 1e-6 * s[1]
    assert np.isfinite(g_j).all() and torch.isfinite(g_p).all()
    assert np.abs(g_j).max() < 1e-6 and float(g_p.abs().max()) < 1e-6


# ------------------------------------------------------------ warp and rays
def _warp_pair(seed=0, skip=(1,)):
    cfg = l2g.L2GConfig(embedding_dim=4, layers_warp=(8, 8, 6),
                        skip_warp=skip)
    jcfg = jl2g.L2GConfig(embedding_dim=4, layers_warp=(8, 8, 6),
                          skip_warp=skip)
    layers = jl2g.init_warp_mlp(jax.random.PRNGKey(seed), jcfg)
    # a live last layer, so that the warps move the rays
    W, b = layers[-1]
    layers[-1] = (W * 0.1, b * 0.1)
    mlp = l2g.WarpMLP(cfg)
    with torch.no_grad():
        for i, (W, b) in enumerate(layers):
            mlp.w[i].copy_(_t(W))
            mlp.b[i].copy_(_t(b))
    return cfg, jcfg, layers, mlp


def test_warp_mlp_matches_jax():
    cfg, jcfg, layers, mlp = _warp_pair()
    uvf = np.random.default_rng(1).normal(size=(5, 7, 6)).astype(np.float32)
    want = np.asarray(jl2g.warp_mlp_apply(jcfg, layers, uvf))
    np.testing.assert_allclose(mlp(_t(uvf)).detach().numpy(), want,
                               atol=1e-6)
    assert mlp.w[1].shape == (8 + 6, 8)        # the skip's input


def _jax_error_draws(key, shape_map, n_rays):
    """The step's error-map uniforms from JAX's key chain."""
    rng, ks = jax.random.split(key)
    kg, kj = jax.random.split(ks)
    g = jax.random.uniform(kg, shape_map, minval=1e-10, maxval=1.0)
    j = jax.random.uniform(kj, (2, shape_map[0], n_rays))
    return rng, ks, (_t(g), _t(j))


def test_sample_error_map_rays_matches_jax():
    em = np.random.default_rng(2).uniform(0.1, 2.0, (3, 64)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    _, ks, draws = _jax_error_draws(key, em.shape, 20)
    j_idx, j_coarse = jl2g.sample_error_map_rays(jnp.asarray(em), ks, 16,
                                                 12, 8, 20)
    p_idx, p_coarse = l2g.sample_error_map_rays(_t(em), 16, 12, 8, 20,
                                                *draws)
    np.testing.assert_array_equal(p_coarse.numpy(), np.asarray(j_coarse))
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    assert all(len(set(r)) == 20 for r in p_coarse.numpy())


@pytest.mark.parametrize("per_view", [False, True], ids=["shared", "per_view"])
def test_local_pose_and_rays_matches_jax(scene, per_view):
    cfg, jcfg, layers, mlp = _warp_pair(seed=3)
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(4, 4)).astype(np.float32)
    view_sel = np.array([0, 2, 3])
    base = scene.poses[view_sel]
    ii = scene.intr_inv[view_sel]
    idx = (rng.integers(0, 256, (3, 10)) if per_view
           else rng.permutation(256)[:10])
    jparams = jl2g.L2GParams(field=None, warp_embedding=jnp.asarray(emb),
                             warp_mlp=layers)
    want = jl2g.local_pose_and_rays(jcfg, jparams, jnp.asarray(base),
                                    jnp.asarray(view_sel), jnp.asarray(ii),
                                    jnp.asarray(idx), 16, 16)
    got = l2g.local_pose_and_rays(_t(emb), mlp, _t(base), _t(view_sel),
                                  _t(ii), _t(idx), 16, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)


# ------------------------------------------------------------ one step
@pytest.fixture(scope="module")
def jax_trainer(scene):
    jt = JL2GTrainer(jset_options(CFG, SMALL), _jscene(scene))
    # a live warp: the last layer drawn small instead of zero
    mlp = list(jt.state.params.warp_mlp)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    W, b = mlp[-1]
    mlp[-1] = (jax.random.normal(k1, W.shape) * 0.02,
               jax.random.normal(k2, b.shape) * 0.02)
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, warp_mlp=mlp))
    return jt


def _port_trainer(jt, scene, extra=()):
    pt = L2GTrainer(set_options(CFG, SMALL + list(extra)), scene,
                    device="cpu")
    pt.state = l2g_state_from_numpy(flatten_l2g_state(jt.state), pt.vm_cfg,
                                    pt.l2g_cfg)
    pt.pose_base = _t(jt.pose_base)
    pt._refresh_bbox_k()
    return pt


def _close_state(p: dict, j: dict, lrs, what):
    """Every leaf of two converter dicts: moments at rtol 1e-3 of the leaf
    max, parameters within 3 x their lr, the rest at atol 1e-5."""
    def leaves(d, prefix=""):
        if isinstance(d, dict):
            for k, v in d.items():
                yield from leaves(v, f"{prefix}.{k}")
        elif isinstance(d, list):
            for i, v in enumerate(d):
                yield from leaves(v, f"{prefix}[{i}]")
        else:
            yield prefix, d

    jl = dict(leaves(j))
    for name, a in leaves(p):
        b = np.asarray(jl[name], np.float32)
        a = np.asarray(a, np.float32)
        if name.endswith("count"):
            assert int(a) == int(b), (what, name)
            continue
        if ".mu" in name or ".nu" in name or "accum" in name:
            tol = 1e-3 * (np.abs(b).max() + 1e-30)
        elif "optimised_poses" in name or "error_map" in name:
            tol = 1e-5
        elif "warp" in name:
            tol = 3 * lrs["pose"]
        elif any(g in name for g in ("planes", "lines")):
            tol = 3 * lrs["index"]
        else:
            tol = 3 * lrs["basis"] + 1e-6
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("do_step", [1.0, 0.0], ids=["pose_step",
                                                      "accumulate"])
def test_l2g_step_matches_jax(jax_trainer, scene, do_step):
    jt = jax_trainer
    V, H, W, R = 4, 16, 16, 9
    S = jt.n_samples
    jcfg = JStepConfig(H=H, W=W, n_views=V, rays_per_view=R, n_samples=S,
                       pose_opt=True, white_bg=False, mask_stride=2)
    step = jl2g.make_l2g_train_step(jcfg, jt.l2g_cfg, jt.vm_cfg, jt.head)
    lrs = {"index": 0.02, "basis": 1e-3, "pose": 1e-3}
    js = dataclasses.replace(
        default_scalars(V), lr_index=jnp.float32(lrs["index"]),
        lr_basis=jnp.float32(lrs["basis"]), lr_pose=jnp.float32(lrs["pose"]),
        l1_weight=jnp.float32(8e-5), tv_density_weight=jnp.float32(0.1),
        tv_color_weight=jnp.float32(0.1), use_edge=jnp.float32(1.0),
        edge_factor=jnp.float32(1.5), non_edge_factor=jnp.float32(0.5),
        pose_do_step=jnp.float32(do_step))
    ps = StepScalars(lr_index=lrs["index"], lr_basis=lrs["basis"],
                     lr_pose=lrs["pose"], near_far=(2.0, 6.0),
                     l1_weight=8e-5, tv_density_weight=0.1,
                     tv_color_weight=0.1, use_edge=1.0, edge_factor=1.5,
                     non_edge_factor=0.5, pose_do_step=do_step)
    images = scene.images.reshape(V, 3, -1).transpose(0, 2, 1)
    edges = (np.random.default_rng(0).uniform(size=(V, H * W)) > 0.7
             ).astype(np.float32)
    view_sel = np.arange(V)
    ray_idx = np.arange(R)       # ignored: the error map draws the rays
    key = jax.random.PRNGKey(21 + int(do_step))
    rng, _, error_draws = _jax_error_draws(key, (V, 64), R)
    rng_samp, rng_bg = jax.random.split(rng)
    jitter = _t(jax.random.uniform(rng_samp, (V * R, 1)))
    coin = bool(jax.random.uniform(rng_bg, ()) < 0.5)
    new_j, jm = step(jt.state, jt.pose_base, jnp.asarray(scene.intr),
                     jnp.asarray(scene.intr_inv), jnp.asarray(images),
                     jnp.asarray(edges), jnp.asarray(view_sel),
                     jnp.asarray(ray_idx), key, js, None)

    state = l2g_state_from_numpy(flatten_l2g_state(jt.state), jt_vm(jt),
                                 l2g.L2GConfig(**dataclasses.asdict(
                                     jt.l2g_cfg)))
    pcfg = StepConfig(H=H, W=W, n_views=V, rays_per_view=R, n_samples=S,
                      white_bg=False, mask_stride=2)
    pm, _ = l2g.l2g_train_step(
        state, pcfg, l2g.L2GConfig(**dataclasses.asdict(jt.l2g_cfg)),
        jt_vm(jt), _t(jt.pose_base), _t(scene.intr), _t(scene.intr_inv),
        _t(images), _t(edges), _t(view_sel), _t(ray_idx), ps, jitter=jitter,
        bg_coin=coin, error_draws=error_draws)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(pm["global_alignment"]),
                               float(jm["global_alignment"]), rtol=1e-3,
                               atol=1e-9)
    _close_state(l2g_to_numpy(state), flatten_l2g_state(new_j), lrs,
                 f"do_step {do_step}")
    assert (l2g_to_numpy(state)["error_map"] != 1.0).sum() > 0


def jt_vm(jt):
    """The port's VMConfig of a JAX trainer's options."""
    from joint_tensorf_tpu_torch.train.trainer import build_vm_config
    return build_vm_config(set_options(CFG, SMALL))


def test_l2g_depth_range_matches_jax(scene):
    poses = scene.poses + np.random.default_rng(3).normal(
        size=scene.poses.shape).astype(np.float32) * 0.1
    want = jl2g.l2g_depth_range(jnp.asarray(poses), (2.0, 6.0))
    got = l2g.l2g_depth_range(_t(poses), (2.0, 6.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------ the trainer
def test_l2g_trainer_matches_jax(scene):
    jt = JL2GTrainer(jset_options(CFG, SMALL), _jscene(scene))
    pt = _port_trainer(jt, scene)
    assert pt.compact_k_bbox == jt.compact_k_bbox
    assert pt.resolution == jt.resolution
    seen = set()
    for it in range(4):
        pt.state = l2g_state_from_numpy(flatten_l2g_state(jt.state),
                                        pt.vm_cfg, pt.l2g_cfg)
        V = pt.n_views
        rpv = max(1, pt._n_rays() // V)
        stepw = int(np.ceil((pt.H * pt.W / rpv) ** 0.5))
        R = int(np.ceil(pt.W / stepw) * np.ceil(pt.H / stepw))
        _, step_key = jax.random.split(jt.key)
        rng, _, error_draws = _jax_error_draws(step_key, (V, 64), R)
        jitter = _t(jax.random.uniform(jax.random.split(rng)[0],
                                       (V * R, 1)))
        jm = jt.train_iteration()
        pm = pt.train_iteration(jitter=jitter, error_draws=error_draws)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"it {it}")
        seen.add((pt.last_step_config.compact_k,
                  pt.last_step_config.densify_density))
        p, j = l2g_to_numpy(pt.state), flatten_l2g_state(jt.state)
        for k in ("error_map", "optimised_poses"):
            np.testing.assert_allclose(p[k], j[k], atol=1e-5,
                                       err_msg=f"it {it} {k}")
        jt._update_schedule()
        pt._update_schedule()
        for k in BUDGETS:
            assert getattr(pt, k) == getattr(jt, k), (it, k)
        assert pt.rng_np.bit_generator.state == \
            jt.rng_np.bit_generator.state, it
        assert pt.resolution == jt.resolution and \
            pt.n_samples == jt.n_samples, it
        assert pt._near_far() == pytest.approx(jt._near_far(), rel=1e-6)
        jt.it += 1
        pt.it += 1
    assert pt.alpha_mask is not None and len(pt.upsample_iters) == 1
    assert pt.state.scene_opt.count == 2 and pt.state.pose_opt.count == 4


# ------------------------------------------------------------ checkpoints
def test_l2g_checkpoint_both_ways(jax_trainer, scene, tmp_path):
    jt = jax_trainer
    jt.it = 3
    path = str(tmp_path / "jax_l2g.ckpt.npz")
    jckpt.save_checkpoint(path, jt)
    pt = L2GTrainer(set_options(CFG, SMALL), scene, device="cpu")
    ckpt.restore_checkpoint(path, pt)
    want = flatten_l2g_state(jt.state)
    _close_state(l2g_to_numpy(pt.state), want,
                 {"index": 0, "basis": 0, "pose": 0}, "jax -> port")
    assert pt.it == 3 and pt.resolution == jt.resolution
    back = str(tmp_path / "port_l2g.ckpt.npz")
    ckpt.save_checkpoint(back, pt)
    assert set(np.load(back).files) >= set(
        k for k in np.load(path).files if k.startswith("state/"))
    jt2 = JL2GTrainer(jset_options(CFG, SMALL), _jscene(scene))
    jckpt.restore_checkpoint(back, jt2)
    _close_state(flatten_l2g_state(jt2.state), want,
                 {"index": 0, "basis": 0, "pose": 0}, "port -> jax")
    assert jt2.it == 3


# ------------------------------------------------------------ the CLIs
def test_l2g_clis_write_pose_files(tmp_path):
    """Both entry points dispatch model: l2g_bat: the train CLI logs pose
    errors of the registered poses, evaluate writes quant_pose.txt and
    the pose errors beside PSNR."""
    import json
    import os

    from joint_tensorf_tpu_torch import evaluate
    from joint_tensorf_tpu_torch.train import __main__ as train_cli

    args = [f"--yaml={CFG}", "--device=cpu", f"--output_root={tmp_path}",
            "--name=l2g", "--+tb_logging=false", "--freq.scalar=2",
            "--freq.val=0", "--max_iter=4", "--data.val_sub=2"] + [
        a for a in SMALL if not a.startswith("--max_iter")]
    train_cli.main(args)
    out = os.path.join(tmp_path, "default", "l2g")
    with open(os.path.join(out, "quant.json")) as f:
        quant = json.load(f)
    assert np.isfinite(quant["rot_deg"]) and np.isfinite(quant["val_psnr"])
    res = evaluate.main(args + ["--optim.test_iter=2",
                                "--generate_video=false",
                                "--generate_pose_video=false"])
    assert res["rot_deg"] == pytest.approx(quant["rot_deg"], rel=1e-5)
    with open(os.path.join(out, "quant_pose.txt")) as f:
        assert len(f.readlines()) == 4
