"""PyTorch port vs JAX: the two-stage appearance (app_k).

Only the app_k samples of largest weight among those past the weight gate
are shaded (joint_tensorf_tpu/render/renderer.py:534-607).  Each case
compares the port's render_rays with JAX's on the same rays, jitter and
field, outputs at atol 1e-5 and gradients w.r.t. every field leaf and the
ray centers and directions at rtol 1e-4 and atol 1e-4 of each leaf's
largest entry (tests/test_torch_compaction.assert_matches_jax):

* app_k below the gated count of most rays (the clipping case), with and
  without the blur;
* the trainer's blurred-phase combination: app_k with the dense-grid
  density and in-bbox compaction;
* app_k under mask compaction.

With app_k at S the port's two-stage render equals its own dense
appearance render (atol 1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_compaction import (NEAR_FAR, PCFG, assert_matches_jax,
                                   blob_state, masks, port_render, rays)
from torch_parity import flatten_field

from joint_tensorf_tpu.render import renderer as jrenderer
from joint_tensorf_tpu_torch.convert import field_from_numpy
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops.composite import transmittance
from joint_tensorf_tpu_torch.render.renderer import (RenderConfig,
                                                     sample_ray_axes,
                                                     step_size)

S = 160


def gated_counts(st):
    """Per-ray count of samples past the weight gate in the sharp field
    (the clipping case needs most rays above app_k)."""
    field = field_from_numpy(flatten_field(st), PCFG)
    centers, dirs, jitter, _, _ = rays(96, 0)
    aabb = field.aabb
    axes_w, z, inb, _ = sample_ray_axes(
        aabb, step_size(aabb, field.resolution(), PCFG.step_ratio), S,
        torch.as_tensor(centers), torch.as_tensor(dirs), *NEAR_FAR, True,
        jitter=torch.as_tensor(jitter))
    coords = tuple(vm.normalize_coord(w, aabb[:, a]).reshape(-1)
                   for a, w in enumerate(axes_w))
    sigma = vm.feature2density(
        PCFG, vm.compute_density_feature(field, PCFG, coords)).reshape(z.shape)
    sigma = torch.where(inb, sigma, torch.zeros_like(sigma))
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1)
    _, _, w = transmittance(1.0 - torch.exp(-sigma * dists
                                            * PCFG.distance_scale))
    return ((w > PCFG.raymarch_weight_thres) & inb).sum(-1)


# (name, app_k, blur, densify, compact_k, mask)
CASES = [
    ("clipping", 8, False, False, None, False),
    ("clipping_blur", 8, True, False, None, False),
    ("blur_densify_bbox_compaction", 12, True, True, 96, False),
    ("mask_compaction", 12, False, False, 64, True),
]


@pytest.mark.parametrize("name,app_k,blur,densify,compact_k,use_mask",
                         CASES, ids=[c[0] for c in CASES])
def test_two_stage_render_matches_jax(name, app_k, blur, densify, compact_k,
                                      use_mask):
    st = blob_state(seed=2, scale=1.5)
    jmask = mask = None
    if use_mask:
        jmask, mask = masks(st)
    stride = 4
    jr = jrenderer.RenderConfig(
        n_samples=S, is_train=True, white_bg=True, use_alpha_mask=use_mask,
        mask_stride=stride, compact_k=compact_k, densify_density=densify,
        app_k=app_k)
    rcfg = RenderConfig(n_samples=S, is_train=True, mask_stride=stride,
                        compact_k=compact_k, densify_density=densify,
                        app_k=app_k)
    if name.startswith("clipping"):
        n_gate = gated_counts(st)
        assert float((n_gate > app_k).float().mean()) > 0.5, n_gate
    assert_matches_jax(st, jr, rcfg, jmask=jmask, mask=mask, blur=blur)


@pytest.mark.parametrize("blur", [False, True])
def test_two_stage_at_S_equals_dense_appearance(blur):
    field = field_from_numpy(flatten_field(blob_state(seed=3, scale=1.5)),
                             PCFG)
    centers, dirs, jitter, _, _ = rays(96, 1)
    rcfg = RenderConfig(n_samples=S, is_train=True, app_k=S)
    (rgb, _, acc), _, _ = port_render(field, rcfg, centers, dirs, jitter,
                                      blur=blur)
    (d_rgb, _, d_acc), _, _ = port_render(
        field, dataclasses.replace(rcfg, app_k=None), centers, dirs, jitter,
        blur=blur)
    np.testing.assert_allclose(rgb.detach().numpy(), d_rgb.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(acc.detach().numpy(), d_acc.detach().numpy(),
                               atol=1e-5)
    assert float(acc.max()) > 0.5
