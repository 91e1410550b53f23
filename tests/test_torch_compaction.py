"""PyTorch port vs JAX: render_rays with sample compaction.

Each case renders the same rays, jitter and field (a density blob, so the
alpha mask is selective) through the JAX renderer and the port's, in train
mode, and compares rgb and opacity at atol 1e-5 and the gradients w.r.t.
every field leaf and w.r.t. the ray centers and directions (the pose path)
at rtol 1e-4 and atol 1e-4 of each leaf's largest entry, as
tests/test_torch_render.py compares the dense path.  The forms of
joint_tensorf_tpu/render/renderer.py:325-436:

* group selection under the alpha mask (stride 2, K a multiple of it);
* group selection on the in-bbox gate alone, under the blur, with no mask
  in use (stride 4);
* per-sample selection: S not a multiple of the stride, and K not a
  multiple of it;
* group selection under the blur through a dilated mask (JAX's
  mask_with_blur; the port gates on whatever mask it is given);
* with the dense-grid density, and with K below the live count (clipping).

Where K covers every live sample, the port's compacted render also equals
its own uncompacted render (atol 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import field_leaves, flatten_field

from joint_tensorf_tpu.models import alpha_mask as jam
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.render import renderer as jrenderer
from joint_tensorf_tpu_torch.convert import field_from_numpy
from joint_tensorf_tpu_torch.models import alpha_mask as am
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.render.renderer import (BlurSpec, RenderConfig,
                                                     render_rays,
                                                     sample_ray_axes,
                                                     step_size)
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

JCFG = jvm.VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                    app_dim=6, hidden=8)
PCFG = vm.VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                   app_dim=6, hidden=8)
BOX = [-1.5] * 3 + [1.5] * 3
RES = (22, 22, 22)
NEAR_FAR = (2.0, 6.0)
BLUR = dict(c2f_density=0.1, c2f_color=0.15)


def blob_state(seed=0, scale=6.0):
    """Density factors positive only inside a sub-box of the grid."""
    st = jvm.init_vm(jax.random.PRNGKey(seed), JCFG, RES, BOX)
    rng = np.random.default_rng(seed)
    inside = [(np.arange(r) >= lo * (r - 1)) & (np.arange(r) <= hi * (r - 1))
              for r, lo, hi in zip(RES, (0.3, 0.2, 0.35), (0.7, 0.6, 0.8))]
    planes, lines = [], []
    for i in range(3):
        m0, m1 = jvm.MAT_MODE[i]
        ax = jvm.VEC_MODE[i]
        p = rng.uniform(0.5, 1.0, (RES[m1], RES[m0], 3)).astype(np.float32)
        planes.append(p * (inside[m1][:, None] & inside[m0][None, :])[..., None]
                      * scale)
        l = rng.uniform(0.5, 1.0, (RES[ax], 3)).astype(np.float32)
        lines.append(l * inside[ax][:, None])
    return dataclasses.replace(
        st, density_planes=[jnp.asarray(p) for p in planes],
        density_lines=[jnp.asarray(l) for l in lines])


def rays(n, seed):
    rng = np.random.default_rng(seed)
    centers = (np.array([0.0, 0.0, -4.0]) + rng.normal(0, 0.05, (n, 3))
               ).astype(np.float32)
    xy = rng.uniform(-0.4, 0.4, (n, 2))
    dirs = np.concatenate([xy, np.ones((n, 1))], -1).astype(np.float32)
    jitter = rng.random((n, 1)).astype(np.float32)
    g_rgb = rng.standard_normal((n, 3)).astype(np.float32)
    g_acc = rng.standard_normal(n).astype(np.float32)
    return centers, dirs, jitter, g_rgb, g_acc


def masks(st, dilate=0):
    """The JAX mask of the state (dilated by ``dilate`` cells) and the
    port's copy."""
    jmask, _ = jam.update_alpha_mask(st, JCFG, list(RES), 0.07, 1e-5)
    if dilate:
        jmask = jam.dilate_mask(jmask, dilate)
    return jmask, am.AlphaMask(grid=torch.tensor(np.asarray(jmask.grid)),
                               aabb=torch.tensor(np.asarray(jmask.aabb)))


def port_render(field, rcfg, centers, dirs, jitter, mask=None, blur=False,
                stats=None):
    tc = torch.tensor(centers, requires_grad=True)
    td = torch.tensor(dirs, requires_grad=True)
    out = render_rays(field, PCFG, rcfg, tc, td, NEAR_FAR,
                      blur=BlurSpec("uniform-gaussian", 8) if blur else None,
                      ray_jitter=torch.tensor(jitter), alpha_mask=mask,
                      stats=stats, **(BLUR if blur else {}))
    return out, tc, td


def assert_matches_jax(st, jr, rcfg, n=96, seed=0, jmask=None, mask=None,
                       blur=False):
    """Port vs JAX outputs and gradients for one configuration; returns
    the port's stats and its outputs."""
    centers, dirs, jitter, g_rgb, g_acc = rays(n, seed)
    head = JCFG.shading_head()
    kw = dict(blur=jrenderer.BlurSpec("uniform-gaussian", 8),
              c2f_density=jnp.float32(BLUR["c2f_density"]),
              c2f_color=jnp.float32(BLUR["c2f_color"])) if blur else {}

    def jloss(s, c, d):
        rgb, _, acc = jrenderer.render_rays(
            s, JCFG, jr, head, c, d, jax.random.PRNGKey(0),
            jnp.array(NEAR_FAR), alpha_mask=jmask,
            ray_jitter=jnp.asarray(jitter), **kw)
        return jnp.sum(rgb * g_rgb) + jnp.sum(acc * g_acc), (rgb, acc)

    (_, (j_rgb, j_acc)), (g_st, g_c, g_d) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            st, jnp.asarray(centers), jnp.asarray(dirs))

    field = field_from_numpy(flatten_field(st), PCFG)
    stats = {}
    (rgb, _, acc), tc, td = port_render(field, rcfg, centers, dirs, jitter,
                                        mask=mask, blur=blur, stats=stats)
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
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)
    assert np.abs(want["dirs"]).max() > 0        # the pose path is live
    return stats, (rgb.detach(), acc.detach())


def live_slots(S, stride, n=96, seed=0, mask=None):
    """The most sample slots any ray keeps live, counted as the renderer
    selects them (live probe groups x stride; the in-bbox gate alone
    without a mask)."""
    centers, dirs, _, _, _ = rays(n, seed)
    aabb = torch.tensor(BOX).reshape(2, 3)
    axes_w, _, inb, _ = sample_ray_axes(
        aabb, step_size(aabb, RES, PCFG.step_ratio), S,
        torch.as_tensor(centers), torch.as_tensor(dirs), *NEAR_FAR, False)
    alive = inb.reshape(len(centers), S // stride, stride).any(-1)
    if mask is not None:
        probe = tuple(w[:, ::stride].reshape(-1) for w in axes_w)
        alive &= am.sample_alpha(mask, probe).reshape(alive.shape) > 0
    return int(alive.sum(-1).max()) * stride


# (name, S, stride, K, mask: None | "sharp" | "dilated", blur, densify)
CASES = [
    ("group_mask", 160, 2, 64, "sharp", False, False),
    ("group_mask_clipping", 160, 2, 16, "sharp", False, False),
    ("group_bbox_blur", 160, 4, 96, None, True, False),
    ("per_sample_odd_S", 161, 2, 64, "sharp", False, False),
    ("per_sample_odd_K", 160, 2, 63, "sharp", False, False),
    ("group_dilated_mask_blur", 160, 2, 64, "dilated", True, False),
    ("group_bbox_blur_densify", 160, 4, 96, None, True, True),
]


@pytest.mark.parametrize("name,S,stride,K,mask_kind,blur,densify", CASES,
                         ids=[c[0] for c in CASES])
def test_compacted_render_matches_jax(name, S, stride, K, mask_kind, blur,
                                      densify):
    st = blob_state(seed=1)
    jmask = mask = None
    if mask_kind is not None:
        jmask, mask = masks(st, dilate=2 if mask_kind == "dilated" else 0)
    use_mask = mask_kind is not None
    with_blur = blur and use_mask
    jr = jrenderer.RenderConfig(
        n_samples=S, is_train=True, white_bg=True, use_alpha_mask=use_mask,
        mask_with_blur=with_blur, mask_stride=stride, compact_k=K,
        densify_density=densify)
    rcfg = RenderConfig(n_samples=S, is_train=True, mask_stride=stride,
                        compact_k=K, densify_density=densify)
    stats, (rgb, acc) = assert_matches_jax(st, jr, rcfg, jmask=jmask,
                                           mask=mask, blur=blur)
    assert float(stats["kept_frac"]) == pytest.approx(K / S)
    g = stride if S % stride == 0 else 1
    if live_slots(S, g, mask=mask) <= K:
        # K covers every live slot: equal to the port's own dense render
        field = field_from_numpy(flatten_field(st), PCFG)
        centers, dirs, jitter, _, _ = rays(96, 0)
        (d_rgb, _, d_acc), _, _ = port_render(
            field, dataclasses.replace(rcfg, compact_k=None), centers, dirs,
            jitter, mask=mask, blur=blur)
        np.testing.assert_allclose(rgb.numpy(), d_rgb.detach().numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(acc.numpy(), d_acc.detach().numpy(),
                                   atol=1e-5)
    else:
        assert "clipping" in name, (name, live_slots(S, g, mask=mask))
