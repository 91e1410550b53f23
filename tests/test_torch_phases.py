"""PyTorch port vs JAX: BAT past its first phase.

* resize_matrix (exact), upsample (atol 1e-6: the same matmuls, summed in
  another order) and shrink (the crop and the snapped box exact) on
  factors converted from JAX;
* update_alpha_mask on a field with a box-shaped density blob: the mask
  grid and the proposed box equal;
* the sample_alpha gate equal on grid nodes, cell midpoints and points
  past the box (the port samples trilinearly, JAX through its packed
  neighbourhood layout);
* render_rays with a mask, no blur, in train mode with the same jitter, at
  stride 1, at stride 2, and with S not a multiple of the stride: outputs
  at atol 1e-5 and gradients at rtol 1e-4 / atol 1e-4 of each leaf's max,
  as tests/test_torch_render.py compares the unmasked path;
* both trainers through upsample_iters [2, 4] and update_alphamask_iters
  [5] with S <= 128 (so the JAX trainer's compaction budget equals S and
  it does not compact): resolution, box, n_samples, learning rates, the
  factors (atol 1e-6), fresh field moments with the pose optimiser kept,
  the mask grid, and the ray indices and blur scales drawn after the mask
  update;
* a CPU run of the port trainer through every transition.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import field_leaves, flatten_field, flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data.base import SceneData as JSceneData
from joint_tensorf_tpu.models import alpha_mask as jam
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.ops import resample as jresample
from joint_tensorf_tpu.render import renderer as jrenderer
from joint_tensorf_tpu.train.optim import AdamState as JAdamState
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import (field_from_numpy, to_numpy,
                                             train_state_from_numpy)
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.models import alpha_mask as am
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import cuda_build, resample
from joint_tensorf_tpu_torch.render.renderer import RenderConfig, render_rays
from joint_tensorf_tpu_torch.train.step import init_train_state
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

JCFG = jvm.VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                    app_dim=6, hidden=8)
PCFG = vm.VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                   app_dim=6, hidden=8)
BOX = [-1.5] * 3 + [1.5] * 3


def _blob_density(res, rng, lo=(0.3, 0.2, 0.35), hi=(0.7, 0.6, 0.8),
                  scale=6.0):
    """Density factors that are positive only inside a sub-box (fractions
    lo..hi of each axis), so the feature is large there and zero outside."""
    res = [int(r) for r in res]
    inside = [(np.arange(r) >= lo[a] * (r - 1))
              & (np.arange(r) <= hi[a] * (r - 1)) for a, r in enumerate(res)]
    planes, lines = [], []
    for i in range(3):
        m0, m1 = jvm.MAT_MODE[i]
        ax = jvm.VEC_MODE[i]
        p = rng.uniform(0.5, 1.0, (res[m1], res[m0], 3)).astype(np.float32)
        p *= (inside[m1][:, None] & inside[m0][None, :])[..., None] * scale
        l = rng.uniform(0.5, 1.0, (res[ax], 3)).astype(np.float32)
        lines.append(l * inside[ax][:, None])
        planes.append(p)
    return planes, lines


def _blob_state(res, seed=0):
    st = jvm.init_vm(jax.random.PRNGKey(seed), JCFG, res, BOX)
    planes, lines = _blob_density(res, np.random.default_rng(seed))
    return dataclasses.replace(
        st, density_planes=[jnp.asarray(p) for p in planes],
        density_lines=[jnp.asarray(l) for l in lines])


def _port_field(st):
    return field_from_numpy(flatten_field(st), PCFG)


def _assert_fields(got: dict, want: dict, atol):
    gl, wl = field_leaves(got), field_leaves(want)
    assert set(gl) == set(wl)
    for k in wl:
        assert gl[k].shape == wl[k].shape, k
        np.testing.assert_allclose(gl[k], wl[k], rtol=0, atol=atol,
                                   err_msg=k)


def _field_dict(field):
    """A port VMField -> the converter's field-shaped dict."""
    return to_numpy(init_train_state(field, 1))


# ----------------------------------------- resample / upsample / shrink
@pytest.mark.parametrize("src,dst", [(1, 5), (5, 1), (16, 23), (23, 16),
                                     (64, 101)])
def test_resize_matrix_exact(src, dst):
    np.testing.assert_array_equal(resample.resize_matrix(src, dst),
                                  jresample.resize_matrix(src, dst))


def test_upsample_matches_jax():
    st = _blob_state((10, 12, 9))
    target = [17, 15, 21]
    want = flatten_field(jvm.upsample(st, target))
    got = vm.upsample(_port_field(st), target)
    assert got.resolution() == target
    _assert_fields(_field_dict(got), want, atol=1e-6)


def test_shrink_matches_jax():
    st = _blob_state((20, 16, 24))
    new_aabb = np.array([[-0.71, -1.13, -0.37], [1.04, 0.52, 1.5]],
                        np.float32)
    jst = jvm.shrink(st, new_aabb)
    got = vm.shrink(_port_field(st), new_aabb)
    assert got.resolution() == jst.resolution()
    np.testing.assert_array_equal(got.aabb.numpy(), np.asarray(jst.aabb))
    _assert_fields(_field_dict(got), flatten_field(jst), atol=0)


# -------------------------------------------------------------- alpha mask
def test_update_alpha_mask_matches_jax():
    st = _blob_state((14, 12, 16))
    res, step, thresh = [14, 12, 16], 0.07, 1e-5
    jmask, jbox = jam.update_alpha_mask(st, JCFG, res, step, thresh)
    mask, box = am.update_alpha_mask(_port_field(st), PCFG, res, step,
                                     thresh)
    grid = mask.grid.numpy()
    np.testing.assert_array_equal(grid, np.asarray(jmask.grid))
    assert 0 < grid.mean() < 0.7                 # the blob, dilated
    assert box.dtype == np.float32
    np.testing.assert_array_equal(box, jbox)
    assert np.all(box[0] > -1.5) and np.all(box[1] <= 1.5)
    np.testing.assert_array_equal(
        am.capped_mask_res([400, 300, 500], 256 ** 3),
        jam.capped_mask_res([400, 300, 500], 256 ** 3))


def test_sample_alpha_gate_matches_jax():
    rng = np.random.default_rng(5)
    X, Y, Z = 7, 9, 11
    grid = (rng.random((X, Y, Z)) > 0.8).astype(np.float32)
    aabb = np.array([[-1.2, -0.9, -1.4], [1.1, 1.3, 0.8]], np.float32)
    jmask = jam.AlphaMask(grid=jnp.asarray(grid), aabb=jnp.asarray(aabb),
                          packed=jam.pack_neighborhoods(jnp.asarray(grid)))
    mask = am.AlphaMask(grid=torch.as_tensor(grid), aabb=torch.as_tensor(aabb))
    pts = []
    for a, n in enumerate((X, Y, Z)):
        # grid nodes, cell midpoints, and points past each face
        t = np.concatenate([np.arange(n), np.arange(n - 1) + 0.5,
                            [-0.7, n - 0.3]]) / (n - 1)
        pts.append(aabb[0, a] + (aabb[1, a] - aabb[0, a]) * t)
    mesh = [m.reshape(-1).astype(np.float32)
            for m in np.meshgrid(*pts, indexing="ij")]
    want = np.asarray(jam.sample_alpha(jmask, tuple(jnp.asarray(m)
                                                    for m in mesh))) > 0
    got = am.sample_alpha(mask, tuple(torch.as_tensor(m)
                                      for m in mesh)).numpy() > 0
    np.testing.assert_array_equal(got, want)
    assert 0.1 < want.mean() < 0.9


# ------------------------------------------------------- masked render_rays
@pytest.mark.parametrize("S,stride", [(40, 1), (40, 2), (41, 2)])
def test_masked_render_matches_jax(S, stride):
    st = _blob_state((12, 12, 12), seed=1)
    jmask, _ = jam.update_alpha_mask(st, JCFG, [12, 12, 12], 0.125, 1e-5)
    mask = am.AlphaMask(grid=torch.as_tensor(np.asarray(jmask.grid)),
                        aabb=torch.as_tensor(np.asarray(jmask.aabb)))
    rng = np.random.default_rng(S + stride)
    n = 40
    centers = (np.array([0.0, 0.0, -4.0]) + rng.normal(0, 0.05, (n, 3))
               ).astype(np.float32)
    xy = rng.uniform(-0.35, 0.35, (n, 2))
    dirs = np.concatenate([xy, np.ones((n, 1))], -1).astype(np.float32)
    g_rgb = rng.standard_normal((n, 3)).astype(np.float32)
    g_acc = rng.standard_normal(n).astype(np.float32)
    key = jax.random.PRNGKey(S)
    jitter = np.asarray(jax.random.uniform(jax.random.split(key)[0], (n, 1)))
    jr = jrenderer.RenderConfig(n_samples=S, is_train=True, white_bg=True,
                                use_alpha_mask=True, mask_stride=stride,
                                compact_k=None)
    head = JCFG.shading_head()

    def jloss(s, c, d):
        rgb, _, acc = jrenderer.render_rays(
            s, JCFG, jr, head, c, d, key, jnp.array([2.0, 6.0]),
            alpha_mask=jmask)
        return jnp.sum(rgb * g_rgb) + jnp.sum(acc * g_acc), (rgb, acc)

    (_, (j_rgb, j_acc)), (g_st, g_c, g_d) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            st, jnp.asarray(centers), jnp.asarray(dirs))

    field = _port_field(st)
    tc = torch.as_tensor(centers).requires_grad_(True)
    td = torch.as_tensor(dirs).requires_grad_(True)
    stats = {}
    rgb, _, acc = render_rays(
        field, PCFG, RenderConfig(n_samples=S, is_train=True,
                                  mask_stride=stride),
        tc, td, (2.0, 6.0), ray_jitter=torch.as_tensor(jitter),
        alpha_mask=mask, stats=stats)
    # the mask culls part of the in-box samples, not all of them
    assert 0 < float(stats["valid_frac"]) < float(stats["inbbox_frac"])
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb),
                               atol=1e-5)
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(j_acc),
                               atol=1e-5)
    assert float(acc.max()) > 0.5                # rays cross the blob
    (torch.sum(rgb * torch.as_tensor(g_rgb))
     + torch.sum(acc * torch.as_tensor(g_acc))).backward()
    want = field_leaves(flatten_field(g_st))
    want["centers"], want["dirs"] = np.asarray(g_c), np.asarray(g_d)
    got = {k: p.grad.numpy() for k, p in field.named_parameters()}
    got["centers"], got["dirs"] = tc.grad.numpy(), td.grad.numpy()
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)


# ------------------------------------------------------------- the trainers
CFG = "configs/bat_blender_VM.yaml"
SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
         "--train_schedule.n_voxel_final=13824",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=20",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--train_schedule.upsample_iters=[2,4]",
         "--train_schedule.update_alphamask_iters=[5]",
         "--tpu.bbox_compact=false", "--tpu.densify_density=false",
         "--tpu.app_k=null", "--tpu.blur_mask_compact=false"]


@pytest.fixture(scope="module")
def small_scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def test_trainer_transitions_match_jax(small_scene):
    sc = small_scene
    jt = JTrainer(jset_options(CFG, SMALL), JSceneData(
        images=sc.images, poses=sc.poses, intr=sc.intr,
        intr_inv=sc.intr_inv, near_far=sc.near_far, H=sc.H, W=sc.W))
    pt = Trainer(set_options(CFG, SMALL), sc, device="cpu")
    assert jt.resolution == pt.resolution == [16, 16, 16]
    # the same blob field on both sides, and non-trivial optimiser state
    planes, lines = _blob_density(jt.resolution, np.random.default_rng(2))
    rng = np.random.default_rng(3)
    field = dataclasses.replace(
        jt.state.params.field,
        density_planes=[jnp.asarray(p) for p in planes],
        density_lines=[jnp.asarray(l) for l in lines])
    def pose():
        return jnp.asarray(rng.random((4, 6)), jnp.float32)

    jt.state = dataclasses.replace(
        jt.state, params=dataclasses.replace(jt.state.params, field=field),
        pose_opt=JAdamState(mu=pose(), nu=pose(), count=jnp.int32(3)),
        pose_grad_accum=pose())
    pt.state, _ = train_state_from_numpy(flatten_train_state(jt.state),
                                         pt.vm_cfg)
    pt.state.scene_opt.count = 5

    for it in range(9):
        if getattr(jt, "_blur_cache_at", None) != (it // 500) * 500:
            jt._refresh_blur_cache()
            jt._blur_cache_at = (it // 500) * 500
        c2f_d, _, sc2d = jt._c2f_params()
        _, ray_idx, _ = jt._sample_rays(jt._strategy(), jt._n_rays())
        s, _, _, p_idx, _, p_sc2d = pt.host_schedule()
        np.testing.assert_array_equal(p_idx, ray_idx, err_msg=f"it {it}")
        assert (s.c2f_density, p_sc2d) == (c2f_d, sc2d), it
        assert s.lr_index == pytest.approx(jt.lr_index, rel=1e-12), it
        jt._update_schedule()
        pt._update_schedule()
        assert pt.resolution == jt.resolution, it
        assert pt.n_samples == jt.n_samples <= 128, it
        assert jt.compact_k is None          # S <= 128: no compaction
        assert pt.lr_index == pytest.approx(jt.lr_index, rel=1e-12), it
        assert pt.lr_basis == pytest.approx(jt.lr_basis, rel=1e-12), it
        if it in (2, 4, 5):
            got, want = to_numpy(pt.state), flatten_train_state(jt.state)
            np.testing.assert_array_equal(got["aabb"], want["aabb"])
            _assert_fields(got, want, atol=1e-6)
            assert got["scene_opt"]["count"] == want["scene_opt"]["count"] == 0
            for g in ("mu", "nu"):
                for k, a in field_leaves(got["scene_opt"][g]).items():
                    assert a.shape == field_leaves(got)[k].shape
                    assert not a.any(), (it, g, k)
                np.testing.assert_array_equal(got["pose_opt"][g],
                                              want["pose_opt"][g])
            assert got["pose_opt"]["count"] == 3
            np.testing.assert_array_equal(got["pose_grad_accum"],
                                          want["pose_grad_accum"])
        if it == 5:
            np.testing.assert_array_equal(pt.alpha_mask.grid.numpy(),
                                          np.asarray(jt.alpha_mask.grid))
            assert pt.alphamask_resolution == jt.alphamask_resolution
            # the first, uncapped mask update shrank the box
            assert np.all(np.diff(pt._field_aabb_np(), axis=0) < 3.0)
        jt.it += 1
        pt.it += 1
    assert pt.resolution != [16, 16, 16]


def test_cpu_run_crosses_every_phase(small_scene):
    opt = set_options(CFG, SMALL + [
        "--max_iter=12", "--train_schedule.update_alphamask_iters=[5,9]"])
    pt = Trainer(opt, small_scene, device="cpu")
    seen = []
    cuda_build.reset_launches()
    hist = pt.run(log_every=1, stats=True, on_step=lambda tr, m: m is None
                  and seen.append((tr.resolution, tr.n_samples,
                                   tr.alpha_mask is not None)))
    assert len(hist) == 12 and all(np.isfinite(h["loss"]) for h in hist)
    assert len({(tuple(r), s) for r, s, _ in seen}) >= 3
    assert [m for *_, m in seen] == [False] * 5 + [True] * 7
    # the blur is off from progress 0.3 on: the mask gates those steps
    assert all(h["valid_frac"] <= h["inbbox_frac"] for h in hist)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())  # plain path
