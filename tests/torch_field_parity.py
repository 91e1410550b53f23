"""Shared by the parity tests of the field zoo (tests/test_torch_cp.py,
tests/test_torch_field_variants.py): a tiny scene, JAX and port states
from one JAX init, and the jitted JAX renderer and train step against the
port's on the same rays, jitter and scalars.

* render_parity: render_rays' rgb, depth and opacity at atol 1e-5, and
  the gradients of a weighted sum of rgb and opacity with respect to the
  rays and every field leaf at atol 1e-4 of each one's largest entry;
* step_parity: n train steps: the loss each step at rtol 1e-4; after the
  first, the Adam moments (0.1 x the gradients, in both packages) at
  atol 1e-4 of each leaf's largest entry; after the last, the pose table
  at atol 1e-5 and the field at atol 3 lr (Adam turns a near-zero
  gradient into a +-lr step whose sign can flip with summation order),
  nearly every entry within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import field_leaves, flatten_field, flatten_train_state

from joint_tensorf_tpu.data import synthetic as jsynthetic
from joint_tensorf_tpu.geometry import lie as jlie, poses as jposes
from joint_tensorf_tpu.geometry.rays import get_center_and_ray as jrays
from joint_tensorf_tpu.render import renderer as jrender
from joint_tensorf_tpu.train import step as jstep
from joint_tensorf_tpu_torch.convert import (field_from_numpy, to_numpy,
                                             train_state_from_numpy)
from joint_tensorf_tpu_torch.render import renderer
from joint_tensorf_tpu_torch.train import step as pstep

V, H, W, R, S = 3, 12, 12, 16, 34
RES = (10, 10, 10)
AABB = [-1.5] * 3 + [1.5] * 3
NEAR_FAR = (2.0, 6.0)
LR_INDEX, LR_BASIS, LR_POSE = 0.02, 1e-3, 1e-3
BLUR = ("uniform-gaussian", 8)


def t(x):
    return torch.as_tensor(np.array(x))


@dataclasses.dataclass
class Scene:
    pose_base: np.ndarray
    intr: np.ndarray
    intr_inv: np.ndarray
    images: np.ndarray
    edges: np.ndarray


def scene(seed: int = 0) -> Scene:
    rng = np.random.default_rng(seed)
    gt = jsynthetic.sphere_poses(V)
    noise = (rng.standard_normal((V, 6)) * 0.05).astype(np.float32)
    pose_base = np.asarray(jposes.compose([jlie.se3_to_SE3(noise), gt]))
    focal = 1.1 * W
    intr = np.broadcast_to(np.array(
        [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32),
        (V, 3, 3)).copy()
    return Scene(pose_base, intr, np.linalg.inv(intr).astype(np.float32),
                 rng.random((V, H * W, 3)).astype(np.float32),
                 (rng.random((V, H * W)) > 0.7).astype(np.float32))


def jax_train_state(jcfg, seed: int = 0, signed: bool = False):
    """JAX's init at RES, the density factors x 8 (so that the field is
    not empty); ``signed``: every factor minus 0.3 x its mean, so that
    some are negative (the variants' |.|, activations and the
    positive-only split act on signs)."""
    ts = jstep.init_train_state(jax.random.PRNGKey(seed), jcfg, RES, AABB,
                                V)
    f = ts.params.field

    def vary(a, scale):
        a = a * scale
        return a - 0.3 * jnp.abs(a).mean() if signed else a

    f.density_planes = [vary(p, 8.0) for p in f.density_planes]
    f.density_lines = [vary(l, 8.0) for l in f.density_lines]
    f.app_planes = [vary(p, 1.0) for p in f.app_planes]
    f.app_lines = [vary(l, 1.0) for l in f.app_lines]
    return ts


def _rays(sc: Scene, n: int = 40):
    idx = np.random.default_rng(3).permutation(H * W)[:n]
    c, d = jrays(H, W, jnp.asarray(sc.pose_base[:1]),
                 jnp.asarray(sc.intr_inv[:1]), ray_idx=jnp.asarray(idx))
    return np.asarray(c).reshape(-1, 3), np.asarray(d).reshape(-1, 3)


def _close_rel(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-7,
                               err_msg=what)


def render_parity(jcfg, pcfg, jr_kw=None, pr_kw=None, blur: bool = True,
                  signed: bool = False, progress=(0.7, 0.5), ts=None,
                  near_far=NEAR_FAR):
    """render_rays of both packages on 40 rays of view 0 (see the module
    docstring); ``jr_kw`` / ``pr_kw``: the JAX / port RenderConfig's
    fields beyond n_samples and is_train (train mode: stratified unless
    told otherwise, with one jitter per ray).  Unstratified samples start
    on the box's face unless ``near_far`` starts them inside it (a face
    sample falls in or out of the box by one rounding).  Returns the port's
    (rgb, depth, opacity) and its gradients {"centers", "dirs", field
    parameter name: tensor or None}."""
    sc = scene()
    st = (ts or jax_train_state(jcfg, signed=signed)).params.field
    field = field_from_numpy(flatten_field(st), pcfg)
    c, d = _rays(sc)
    jitter = np.random.default_rng(4).uniform(
        size=(c.shape[0], 1)).astype(np.float32)
    jr = jrender.RenderConfig(n_samples=S, is_train=True, **(jr_kw or {}))
    pr = renderer.RenderConfig(n_samples=S, is_train=True, **(pr_kw or {}))
    jblur = jrender.BlurSpec(*BLUR) if blur else None
    pblur = renderer.BlurSpec(*BLUR) if blur else None
    vp, fp = progress
    wts = np.array([1.0, 2.0, 3.0], np.float32)

    def jf(st, c, d):
        rgb, depth, acc = jrender.render_rays(
            st, jcfg, jr, jcfg.shading_head(), c, d, jax.random.PRNGKey(5),
            jnp.asarray(near_far), blur=jblur, c2f_density=0.2,
            c2f_color=0.3, view_pe_progress=vp, fea_pe_progress=fp,
            ray_jitter=jitter)
        return jnp.sum(rgb * wts) + 0.5 * jnp.sum(acc), (rgb, depth, acc)

    (_, want), (g_st, g_c, g_d) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(st, c, d)
    ct, dt = t(c).requires_grad_(), t(d).requires_grad_()
    got = renderer.render_rays(
        field, pcfg, pr, ct, dt, near_far, blur=pblur, c2f_density=0.2,
        c2f_color=0.3, view_pe_progress=vp, fea_pe_progress=fp,
        ray_jitter=t(jitter))
    for name, g, w in zip(("rgb", "depth", "opacity"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, err_msg=name)
    params = dict(field.named_parameters())
    loss = torch.sum(got[0] * t(wts)) + 0.5 * torch.sum(got[2])
    grads = torch.autograd.grad(loss, [ct, dt] + list(params.values()),
                                allow_unused=True)
    want_g = {"centers": g_c, "dirs": g_d,
              **field_leaves(flatten_field(g_st))}
    names = ["centers", "dirs"] + list(params)
    for name, g in zip(names, grads):
        w = np.asarray(want_g[name], np.float32)
        _close_rel(np.zeros_like(w) if g is None else g.numpy(), w, 1e-4,
                   f"gradient of {name}")
    return got, dict(zip(names, grads))


def _scalars(i: int) -> dict:
    return dict(lr_index=LR_INDEX, lr_basis=LR_BASIS, lr_pose=LR_POSE,
                c2f_density=0.1 * (i + 1), c2f_color=0.25, l1_weight=8e-5,
                use_edge=float(i % 2 == 0), edge_factor=1.5,
                non_edge_factor=0.5, view_pe_progress=0.8,
                fea_pe_progress=0.6, pose_do_step=1.0)


def step_parity(jcfg, pcfg, n_steps: int = 3, j_kw=None, p_kw=None,
                blur: bool = True, signed: bool = False, ts=None,
                near_far=NEAR_FAR):
    """n train steps of both packages from one state (see the module
    docstring): JAX's jitted make_train_step, the port's train_step with
    JAX's jitter (drawn from the step key's first half, as the renderer
    draws it, when stratified).  ``j_kw`` / ``p_kw``: StepConfig fields.
    Returns (port TrainState, JAX TrainState)."""
    j_kw, p_kw = dict(j_kw or {}), dict(p_kw or {})
    sc = scene()
    jts = ts or jax_train_state(jcfg, signed=signed)
    jcfg_step = jstep.StepConfig(
        H=H, W=W, n_views=V, rays_per_view=R, n_samples=S, pose_opt=True,
        use_pose_noise=True,
        blur=jrender.BlurSpec(*BLUR) if blur else None, **j_kw)
    jfn = jstep.make_train_step(jcfg_step, jcfg, jcfg.shading_head())
    pcfg_step = pstep.StepConfig(
        H=H, W=W, n_views=V, rays_per_view=R, n_samples=S,
        blur=renderer.BlurSpec(*BLUR) if blur else None, **p_kw)
    pts, pbase = train_state_from_numpy(
        flatten_train_state(jts, sc.pose_base), pcfg)
    rng = np.random.default_rng(0)
    for i in range(n_steps):
        key = jax.random.PRNGKey(100 + i)
        ray_idx = rng.permutation(H * W)[:R]
        view_sel = np.arange(V)
        s = _scalars(i)
        js = jstep.StepScalars(
            near_far=jnp.asarray(near_far), tv_density_weight=jnp.float32(0),
            tv_color_weight=jnp.float32(0), tv_depth_weight=jnp.float32(0),
            **{k: jnp.float32(v) for k, v in s.items()})
        jts, jm = jfn(jts, jnp.asarray(sc.pose_base), jnp.asarray(sc.intr),
                      jnp.asarray(sc.intr_inv), jnp.asarray(sc.images),
                      jnp.asarray(sc.edges), jnp.asarray(view_sel),
                      jnp.asarray(ray_idx), key, js, None)
        jitter = (t(jax.random.uniform(jax.random.split(key)[0], (V * R, 1)))
                  if pcfg_step.stratified else None)
        pm, _ = pstep.train_step(
            pts, pcfg_step, pcfg, pbase, t(sc.intr_inv), t(sc.images),
            t(sc.edges), t(view_sel), t(ray_idx),
            pstep.StepScalars(near_far=near_far, **s), jitter=jitter)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i} loss")
        if i == 0:
            got, want = to_numpy(pts), flatten_train_state(jts)
            gm = field_leaves(got["scene_opt"]["mu"])
            wm = field_leaves(want["scene_opt"]["mu"])
            assert set(gm) == set(wm)
            for k in wm:
                _close_rel(gm[k], wm[k], 1e-4, f"step-1 moment of {k}")
            _close_rel(got["pose_opt"]["mu"], want["pose_opt"]["mu"], 1e-4,
                       "step-1 moment of se3_refine")
            assert np.abs(want["pose_opt"]["mu"]).max() > 0
    got, want = to_numpy(pts), flatten_train_state(jts)
    np.testing.assert_allclose(got["se3_refine"], want["se3_refine"],
                               atol=1e-5)
    gl, wl = field_leaves(got), field_leaves(want)
    assert set(gl) == set(wl)
    for k in wl:
        lr = LR_INDEX if k.split(".")[0].endswith(("planes", "lines")) \
            else LR_BASIS
        np.testing.assert_allclose(gl[k], wl[k], atol=3 * lr, err_msg=k)
        assert np.mean(np.abs(gl[k] - wl[k]) > 1e-4) < 0.01, k
    return pts, jts
