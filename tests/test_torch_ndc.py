"""PyTorch port vs JAX: the NDC route's modules.

* convert_ndc (with and without the center shift, its detached form) at
  atol 1e-5, and grad_rescale (forward equal to its source, gradient that
  of source * |target| / max(|source|, 0.1), as JAX's);
* sample_ray_ndc under both simulate flags: points, z and the box test
  equal, and the gradients of the points w.r.t. the rays;
* MLP_Fea_WeakView, the relu density activation and the TV terms of the
  planes against the JAX functions (values and gradients);
* render_rays under NDC on a MLP_Fea_WeakView / relu field with the
  random background coin (both faces), the per-sample jitter [N, S]:
  dense, with the dense grid allowed (at these ranks the port samples
  the factors, JAX the grid) and the two-stage appearance, and
  with an alpha mask, the NDC top-k compaction and the two-stage
  appearance:
  rgb, depth and opacity at atol 1e-5 and the gradients w.r.t. the rays
  and the factors at rtol 1e-3 of their max;
* with the dense grid allowed, the route the renderer takes by
  configuration (renderer.density_route): the summed factor sample on a
  VM field, the grid on a CP one, on NDC rays along z; either against
  JAX's dense-grid render, with the gradients of every density factor;
* one NDC training step (relu, WeakView, TV weights, pin_first_pose, the
  coin, the per-sample jitter) from the same state as JAX's
  make_train_step: loss at rtol 1e-4, the Adam moments (the gradients) at
  rtol 1e-3 of each leaf's max, view 0's pose moments exactly zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_parity import flatten_field, flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.geometry import ndc as jndc
from joint_tensorf_tpu.geometry.rays import get_center_and_ray as jrays
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.models.alpha_mask import AlphaMask as JAlphaMask
from joint_tensorf_tpu.render import renderer as jrender
from joint_tensorf_tpu.train import step as jstep
from joint_tensorf_tpu.train.trainer import build_vm_config as jbuild_vm
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import field_from_numpy, \
    train_state_from_numpy, to_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.geometry import ndc
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.models.alpha_mask import AlphaMask
from joint_tensorf_tpu_torch.render import renderer
from joint_tensorf_tpu_torch.train import step as pstep
from joint_tensorf_tpu_torch.train.trainer import build_vm_config
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

CFG = "configs/bat_llff_VM_MLP.yaml"
SMALL = ["--data.dataset=synthetic", "--data.scene=facing",
         "--data.image_size=[12,16]", "--data.n_views=3",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=5", "--arch.shading.mlp_hidden_dim=8"]
RES = (10, 12, 9)
S = 24


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(n_views=3, H=12, W=16, kind="facing",
                                near=0.0, far=1.0, device="cpu")


@pytest.fixture(scope="module")
def fields():
    """A JAX WeakView / relu field (density raised so that the relu is
    live) and the port's copy, with both VMConfigs and the head."""
    jcfg = jbuild_vm(jset_options(CFG, SMALL))
    pcfg = build_vm_config(set_options(CFG, SMALL))
    assert jcfg.shading_mode == pcfg.shading_mode == "MLP_Fea_WeakView"
    assert jcfg.fea2dense == pcfg.fea2dense == "relu"
    aabb = np.array([[-1.5, -1.67, -2.0], [1.5, 1.67, 1.0]], np.float32)
    st = jvm.init_vm(jax.random.PRNGKey(3), jcfg, RES, aabb,
                     init_scale=0.3, init_bias=0.2)
    rng = np.random.default_rng(4)
    st = dataclasses.replace(st, density_planes=[
        p - jnp.asarray(rng.uniform(0, 0.5, p.shape), jnp.float32)
        for p in st.density_planes])
    return jcfg, pcfg, st, field_from_numpy(flatten_field(st), pcfg)


def _rays(scene, idx):
    """JAX's world rays of the 3 views at pixels ``idx``, as numpy."""
    c, d = jrays(12, 16, jnp.asarray(scene.poses), jnp.asarray(
        scene.intr_inv), ray_idx=jnp.asarray(idx))
    return np.asarray(c), np.asarray(d)


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("shift,detach", [(True, False), (True, True),
                                          (False, False)])
def test_convert_ndc_matches_jax(scene, shift, detach):
    c, d = _rays(scene, np.arange(0, 192, 7))
    want = jndc.convert_ndc(c, d, jnp.asarray(scene.intr), near=1.0,
                            center_shift=shift, detach_center_shift=detach)
    got = ndc.convert_ndc(_t(c), _t(d), _t(scene.intr), near=1.0,
                          center_shift=shift, detach_center_shift=detach)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)

    def jf(c, d):
        a, b = jndc.convert_ndc(c, d, jnp.asarray(scene.intr),
                                center_shift=shift,
                                detach_center_shift=detach)
        return jnp.sum(a * 0.3 + b)

    jg = jax.grad(jf, argnums=(0, 1))(c, d)
    ct, dt = _t(c).requires_grad_(), _t(d).requires_grad_()
    a, b = ndc.convert_ndc(ct, dt, _t(scene.intr), center_shift=shift,
                           detach_center_shift=detach)
    pg = torch.autograd.grad(torch.sum(a * 0.3 + b), [ct, dt])
    for g, w in zip(pg, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_grad_rescale_gradient():
    src = np.array([0.05, 0.3, -2.0, 1.0], np.float32)
    tgt = np.array([4.0, -0.6, 1.0, 0.0], np.float32)
    jv, jg = jax.value_and_grad(
        lambda s: jnp.sum(jndc.grad_rescale(s, tgt) * jnp.arange(1.0, 5.0)))(
        src)
    s = _t(src).requires_grad_()
    out = ndc.grad_rescale(s, _t(tgt))
    g, = torch.autograd.grad(torch.sum(out * torch.arange(1.0, 5.0)), s)
    np.testing.assert_allclose(out.detach().numpy(), src, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    # s * |t| / max(|s|, 0.1) is flat in s past |s| = 0.1
    assert g[0] != 0 and torch.all(g[1:] == 0)


@pytest.mark.parametrize("sim_sample", [False, True], ids=["z", "sim_z"])
@pytest.mark.parametrize("sim_depth", [False, True], ids=["t", "sim_t"])
def test_sample_ray_ndc_matches_jax(scene, sim_sample, sim_depth):
    c, d = _rays(scene, np.arange(0, 192, 11))
    c, d = jndc.convert_ndc(c, d, jnp.asarray(scene.intr))
    c, d = np.asarray(c).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    jitter = np.random.default_rng(0).uniform(size=(c.shape[0], S)).astype(
        np.float32)
    aabb = np.array([[-1.5, -1.67, -2.0], [1.5, 1.67, 1.0]], np.float32)

    def jf(c, d):
        pts, z, inb = jrender.sample_ray_ndc(
            aabb, S, c, d, None, jnp.float32(0.0), jnp.float32(1.0), True,
            1.0, sim_sample, sim_depth, jitter=jitter)
        return jnp.sum(pts * jnp.arange(1.0, 4.0)), (pts, z, inb)

    (_, (pts, z, inb)), jg = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(c, d)
    ct, dt = _t(c).requires_grad_(), _t(d).requires_grad_()
    axes, pz, pinb = renderer.sample_ray_ndc(
        _t(aabb), S, ct, dt, 0.0, 1.0, True, 1.0, sim_sample, sim_depth,
        jitter=_t(jitter))
    ppts = torch.stack(axes, -1)
    np.testing.assert_allclose(ppts.detach().numpy(), np.asarray(pts),
                               atol=1e-5)
    np.testing.assert_allclose(pz.numpy(), np.asarray(z), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(pinb.numpy(), np.asarray(inb))
    pg = torch.autograd.grad(torch.sum(ppts * torch.arange(1.0, 4.0)),
                             [ct, dt])
    for g, w in zip(pg, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


# ------------------------------------------------------------ the field
def test_weakview_relu_tv_match_jax(fields):
    jcfg, pcfg, st, field = fields
    rng = np.random.default_rng(6)
    vd = rng.normal(size=(30, 3)).astype(np.float32)
    feat = rng.normal(size=(30, 5)).astype(np.float32)
    head = jcfg.shading_head()
    want = head.apply(st.shading, None, vd, feat, 0.7, 0.4)
    got = field.shading(None, _t(vd), _t(feat), 0.7, 0.4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    x = rng.normal(size=50).astype(np.float32)
    np.testing.assert_allclose(vm.feature2density(pcfg, _t(x)).numpy(),
                               np.asarray(jvm.feature2density(jcfg, x)))

    def jtv(s):
        return jvm.tv_loss_density(s) * 0.3 + jvm.tv_loss_app(s)

    jv, jg = jax.value_and_grad(jtv)(st)
    loss = vm.tv_loss_density(field) * 0.3 + vm.tv_loss_app(field)
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    planes = list(field.density_planes) + list(field.app_planes)
    g = torch.autograd.grad(loss, planes)
    for gp, gj in zip(g, list(jg.density_planes) + list(jg.app_planes)):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gp.numpy(), gj,
                                   atol=1e-5 * np.abs(gj).max())


# ------------------------------------------------------------ the renderer
@pytest.mark.parametrize("variant", ["dense_coin_on", "densify_app_k",
                                     "mask_compact_app_k_coin_off"])
def test_render_rays_ndc_matches_jax(scene, fields, variant):
    jcfg, pcfg, st, field = fields
    c, d = _rays(scene, np.arange(0, 192, 5))
    c, d = jndc.convert_ndc(c, d, jnp.asarray(scene.intr))
    c, d = np.asarray(c).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    n = c.shape[0]
    jitter = np.random.default_rng(1).uniform(size=(n, S)).astype(np.float32)
    compact = variant == "mask_compact_app_k_coin_off"
    densify = variant == "densify_app_k"
    app_k = 6 if variant != "dense_coin_on" else None
    mask = None
    if compact:
        grid = (np.random.default_rng(2).uniform(size=RES[::-1]) > 0.3
                ).astype(np.float32)
        mask = (JAlphaMask(grid=jnp.asarray(grid), aabb=st.aabb),
                AlphaMask(grid=_t(grid), aabb=field.aabb.clone()))
    rcfg = jrender.RenderConfig(
        n_samples=S, white_bg=False, is_train=True, ndc=True,
        use_alpha_mask=mask is not None, mask_stride=2,
        compact_k=12 if compact else None, app_k=app_k,
        densify_density=densify)
    # the first seed whose coin (the renderer's draw from its second key)
    # shows the face the variant asks for
    coin = not compact
    key = next(k for k in map(jax.random.PRNGKey, range(64)) if bool(
        jax.random.uniform(jax.random.split(k)[1], ()) < 0.5) == coin)

    def jf(st, c, d):
        rgb, depth, acc = jrender.render_rays(
            st, jcfg, rcfg, jcfg.shading_head(), c, d, key,
            jnp.asarray([0.0, 1.0]), alpha_mask=None if mask is None
            else mask[0], ray_jitter=jitter)
        return jnp.sum(rgb * jnp.arange(1.0, 4.0)), (rgb, depth, acc)

    (_, want), (jg_st, jg_c, jg_d) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(st, c, d)
    prcfg = renderer.RenderConfig(n_samples=S, is_train=True, white_bg=False,
                                  ndc=True, mask_stride=2,
                                  compact_k=12 if compact else None,
                                  app_k=app_k, densify_density=densify)
    ct, dt = _t(c).requires_grad_(), _t(d).requires_grad_()
    got = renderer.render_rays(field, pcfg, prcfg, ct, dt, (0.0, 1.0),
                               ray_jitter=_t(jitter), bg_coin=coin,
                               alpha_mask=None if mask is None else mask[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    params = dict(field.named_parameters())
    names = [k for k in params if k.split(".")[0] in (
        "density_planes", "app_planes")]
    g = torch.autograd.grad(torch.sum(got[0] * torch.arange(1.0, 4.0)),
                            [ct, dt] + [params[k] for k in names])
    want_g = [jg_c, jg_d] + [getattr(jg_st, k.split(".")[0])[
        int(k.split(".")[1])] for k in names]
    for gp, gj in zip(g, want_g):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gp.numpy(), gj,
                                   atol=1e-3 * np.abs(gj).max() + 1e-7)


@pytest.mark.parametrize("model,route", [("BAT_VMSplit", "factored"),
                                         ("BAT_CP", "grid")])
def test_allowed_dense_grid_takes_the_cheaper_route(model, route):
    """With densify_density on, the renderer builds the dense grid only
    where the summed factor sample (K6) does not apply
    (renderer.density_route): on a 10 x 12 x 9 field of 16 density ranks
    an axis sampled at 40 NDC rays x 24 slots, a VM field takes the
    summed factor sample, a CP field keeps the grid.  The rays run along z
    (x and y within 0.02 of their start), so a ray's slots share their
    xy-plane cell.  Either route matches the JAX renderer's dense-grid
    render: rgb, depth and opacity at atol 1e-5, the gradients w.r.t. the
    rays (the pose path) and every density factor at 1e-3 of their max;
    the span of the route taken is the one traced."""
    args = SMALL + ["--arch.tensorf.density_components=[16,16,16]",
                    f"--arch.tensorf.model={model}"]
    jcfg = jbuild_vm(jset_options(CFG, args))
    pcfg = build_vm_config(set_options(CFG, args))
    aabb = np.array([[-1.5, -1.67, -2.0], [1.5, 1.67, 1.0]], np.float32)
    st = jvm.init_vm(jax.random.PRNGKey(5), jcfg, RES, aabb,
                     init_scale=0.3, init_bias=0.2)
    rng = np.random.default_rng(6)
    st = dataclasses.replace(st, density_planes=[
        p - jnp.asarray(rng.uniform(0, 0.5, p.shape), jnp.float32)
        for p in st.density_planes])
    field = field_from_numpy(flatten_field(st), pcfg)
    n = 40
    c = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), -np.ones((n, 1))],
                       -1).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.02, 0.02, (n, 2)), 2 * np.ones(
        (n, 1))], -1).astype(np.float32)
    jitter = rng.uniform(size=(n, S)).astype(np.float32)
    assert renderer.density_route(
        renderer.RenderConfig(n_samples=S, densify_density=True), pcfg,
        False) == route
    key = jax.random.PRNGKey(0)
    rcfg = jrender.RenderConfig(n_samples=S, is_train=True, ndc=True,
                                densify_density=True)

    def jf(st, c, d):
        rgb, depth, acc = jrender.render_rays(
            st, jcfg, rcfg, jcfg.shading_head(), c, d, key,
            jnp.asarray([0.0, 1.0]), ray_jitter=jitter)
        return jnp.sum(rgb * jnp.arange(1.0, 4.0)), (rgb, depth, acc)

    (_, want), (jg_st, jg_c, jg_d) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(st, c, d)
    ct, dt = _t(c).requires_grad_(), _t(d).requires_grad_()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = renderer.render_rays(
            field, pcfg, renderer.RenderConfig(
                n_samples=S, is_train=True, ndc=True, densify_density=True),
            ct, dt, (0.0, 1.0), ray_jitter=_t(jitter))
    spans = {e.name for e in prof.events()
             if e.name.startswith("jt.render.density.")}
    assert spans == {f"jt.render.density.{route}"}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    params = dict(field.named_parameters())
    names = [k for k in params if k.split(".")[0] in (
        "density_planes", "density_lines")]
    g = torch.autograd.grad(torch.sum(got[0] * torch.arange(1.0, 4.0)),
                            [ct, dt] + [params[k] for k in names])
    want_g = [jg_c, jg_d] + [getattr(jg_st, k.split(".")[0])[
        int(k.split(".")[1])] for k in names]
    assert len(names) == (3 if model == "BAT_CP" else 6)
    for gp, gj in zip(g, want_g):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0
        np.testing.assert_allclose(gp.numpy(), gj,
                                   atol=1e-3 * np.abs(gj).max() + 1e-7)


# ------------------------------------------------------------ the step
def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, d


def test_ndc_step_matches_jax(scene, fields):
    jcfg, pcfg, st, _ = fields
    V, H, W, R = 3, 12, 16, 10
    ts = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, RES,
                                np.asarray(st.aabb), V)
    se3 = jnp.asarray(np.random.default_rng(7).normal(size=(V, 6)) * 0.01,
                      jnp.float32)
    ts = dataclasses.replace(ts, params=dataclasses.replace(
        ts.params, field=st, se3_refine=se3))
    cfg = jstep.StepConfig(H=H, W=W, n_views=V, rays_per_view=R,
                           n_samples=S, pose_opt=True, ndc=True,
                           white_bg=False, mask_stride=2,
                           pin_first_pose=True)
    step = jstep.make_train_step(cfg, jcfg, jcfg.shading_head())
    js = dataclasses.replace(
        jstep.default_scalars(V), lr_index=jnp.float32(0.03),
        lr_basis=jnp.float32(3e-3), lr_pose=jnp.float32(1e-3),
        near_far=jnp.asarray([0.2, 1.0]), l1_weight=jnp.float32(1e-4),
        tv_density_weight=jnp.float32(10.0),
        tv_color_weight=jnp.float32(10.0), use_edge=jnp.float32(1.0),
        edge_factor=jnp.float32(1.5), non_edge_factor=jnp.float32(0.5))
    images = scene.images.reshape(V, 3, -1).transpose(0, 2, 1)
    edges = (np.random.default_rng(8).uniform(size=(V, H * W)) > 0.6
             ).astype(np.float32)
    ray_idx = np.random.default_rng(9).permutation(H * W)[:R]
    key = jax.random.PRNGKey(4)
    rng_samp, rng_bg = jax.random.split(key)
    jitter = _t(jax.random.uniform(rng_samp, (V * R, S)))
    coin = bool(jax.random.uniform(rng_bg, ()) < 0.5)
    new_j, jm = step(ts, jnp.asarray(scene.poses), jnp.asarray(scene.intr),
                     jnp.asarray(scene.intr_inv), jnp.asarray(images),
                     jnp.asarray(edges), jnp.arange(V),
                     jnp.asarray(ray_idx), key, js, None)

    state, _ = train_state_from_numpy(flatten_train_state(ts), pcfg)
    pcfg_s = pstep.StepConfig(H=H, W=W, n_views=V, rays_per_view=R,
                              n_samples=S, ndc=True, white_bg=False,
                              mask_stride=2, pin_first_pose=True)
    ps = pstep.StepScalars(lr_index=0.03, lr_basis=3e-3, lr_pose=1e-3,
                           near_far=(0.2, 1.0), l1_weight=1e-4,
                           tv_density_weight=10.0, tv_color_weight=10.0,
                           use_edge=1.0, edge_factor=1.5,
                           non_edge_factor=0.5)
    pm, _ = pstep.train_step(
        state, pcfg_s, pcfg, _t(scene.poses), _t(scene.intr_inv),
        _t(images), _t(edges), torch.arange(V), _t(ray_idx), ps,
        jitter=jitter, intr=_t(scene.intr), bg_coin=coin)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    got = dict(_leaves(to_numpy(state)))
    want = dict(_leaves(flatten_train_state(new_j)))
    for name, b in want.items():
        if (".mu" not in name and ".nu" not in name) or name not in got:
            continue                    # the moments' aabb entry: no leaf
        a, b = np.asarray(got[name], np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * (np.abs(b).max() + 1e-30),
                                   err_msg=name)
    mu = state.pose_opt.mu["se3_refine"]
    assert torch.all(mu[0] == 0) and torch.any(mu[1:] != 0)
