"""PyTorch port vs JAX: the dense-grid density and the dilated mask.

* compute_density_grid (the rank expansion of the density factors), plain
  and through the blur matrices, against JAX (atol 1e-5 of values ~1);
* pack_corners + sample_packed_grid against JAX's packed8 sampler and its
  lane layout (ops/lane_grid.py), which compute one function: values at
  atol 1e-5, gradients w.r.t. every density factor (through the grid
  build, the fold of the packed gradient and the row scatter) and w.r.t.
  the coordinates (the pose path) at rtol 1e-4 and atol 1e-4 of each
  leaf's largest entry, as tests/test_torch_render.py compares;
* dilate_mask bit for bit, at one radius for all axes, at per-axis radii
  with a zero, and at a radius past the grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flatten_field

from joint_tensorf_tpu.models import alpha_mask as jam
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.ops import densify as jdensify
from joint_tensorf_tpu.ops import lane_grid as jlane
from joint_tensorf_tpu_torch.convert import field_from_numpy
from joint_tensorf_tpu_torch.models import alpha_mask as am
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import densify
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

JCFG = jvm.VMConfig(density_n_comp=(3, 4, 2), app_n_comp=(2, 2, 2),
                    app_dim=4, hidden=8)
PCFG = vm.VMConfig(density_n_comp=(3, 4, 2), app_n_comp=(2, 2, 2),
                   app_dim=4, hidden=8)
RES = (13, 11, 9)


def _state(seed=0):
    return jvm.init_vm(jax.random.PRNGKey(seed), JCFG, RES,
                       [-1.5] * 3 + [1.5] * 3, init_scale=0.5, init_bias=0.1)


def _blur_mats(torch_side: bool):
    k = jvm.c2f_kernel("uniform-gaussian", jnp.float32(0.3), 9,
                       jnp.float32(4.0))
    if not torch_side:
        return jvm.make_blur_mats(k, RES)
    return {L: torch.as_tensor(np.asarray(B))
            for L, B in jvm.make_blur_mats(k, RES).items()}


@pytest.mark.parametrize("blurred", [False, True])
def test_density_grid_matches_jax(blurred):
    st = _state(1)
    want = jvm.compute_density_grid(st, JCFG,
                                    blur_mats=_blur_mats(False) if blurred
                                    else None)
    field = field_from_numpy(flatten_field(st), PCFG)
    got = vm.compute_density_grid(field, PCFG,
                                  blur_mats=_blur_mats(True)
                                  if blurred else None)
    assert got.shape == (RES[0], RES[1], RES[2])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["packed8", "lane"])
@pytest.mark.parametrize("blurred", [False, True])
def test_packed_sample_and_gradients_match_jax(layout, blurred):
    st = _state(2)
    rng = np.random.default_rng(3)
    n = 300
    # points inside, on and past the box faces
    coords = rng.uniform(-1.1, 1.1, (3, n)).astype(np.float32)
    coords[:, :6] = [[-1, 1, -1, 1, 0, 1], [1, -1, 0, -1, 1, 1],
                     [-1, -1, 1, 1, 0, -1]]
    cot = rng.standard_normal(n).astype(np.float32)
    jmats = _blur_mats(False) if blurred else None

    def jloss(planes, lines, c):
        s = jvm.VMState(density_planes=planes, density_lines=lines,
                        app_planes=st.app_planes, app_lines=st.app_lines,
                        basis=st.basis, shading=st.shading, aabb=st.aabb)
        G = jvm.compute_density_grid(s, JCFG, blur_mats=jmats)
        if layout == "lane":
            out = jlane.sample_lane_grid(jlane.pack_lane_grid(G), tuple(c),
                                         RES[2])
        else:
            out = jdensify.sample_packed_grid(jdensify.pack_corners(G),
                                              tuple(c))
        return jnp.sum(out * cot), out

    (_, j_out), (g_p, g_l, g_c) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            st.density_planes, st.density_lines, list(jnp.asarray(coords)))

    field = field_from_numpy(flatten_field(st), PCFG)
    tc = [torch.tensor(c, requires_grad=True) for c in coords]
    G = vm.compute_density_grid(field, PCFG, blur_mats=_blur_mats(True)
                                if blurred else None)
    out = densify.sample_packed_grid(densify.pack_corners(G), tuple(tc))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    torch.sum(out * torch.as_tensor(cot)).backward()
    want = {f"density_planes.{i}": np.asarray(g) for i, g in enumerate(g_p)}
    want.update({f"density_lines.{i}": np.asarray(g)
                 for i, g in enumerate(g_l)})
    want.update({f"coord.{a}": np.asarray(g) for a, g in enumerate(g_c)})
    got = {k: p.grad.numpy() for k, p in field.named_parameters()
           if k.startswith("density")}
    got.update({f"coord.{a}": t.grad.numpy() for a, t in enumerate(tc)})
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


def test_packed_sample_equals_factored_density():
    """The port's own identity: the dense-grid sample equals the factored
    density feature at every point."""
    field = field_from_numpy(flatten_field(_state(4)), PCFG)
    rng = np.random.default_rng(5)
    coords = tuple(torch.as_tensor(c) for c in
                   rng.uniform(-1.05, 1.05, (3, 200)).astype(np.float32))
    dense = densify.sample_packed_grid(
        densify.pack_corners(vm.compute_density_grid(field, PCFG)), coords)
    np.testing.assert_allclose(
        dense.detach().numpy(),
        vm.compute_density_feature(field, PCFG, coords).detach().numpy(),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("radius", [2, (3, 1, 0), (0, 0, 1), 20])
def test_dilate_mask_matches_jax(radius):
    rng = np.random.default_rng(7)
    grid = (rng.random((17, 12, 15)) > 0.97).astype(np.float32)
    aabb = np.array([[-1.0, -1.2, -0.8], [1.3, 0.9, 1.1]], np.float32)
    want = jam.dilate_mask(jam.AlphaMask(grid=jnp.asarray(grid),
                                         aabb=jnp.asarray(aabb)), radius)
    got = am.dilate_mask(am.AlphaMask(grid=torch.as_tensor(grid),
                                      aabb=torch.as_tensor(aabb)), radius)
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid))
    np.testing.assert_array_equal(got.aabb.numpy(), aabb)
    assert 0 < float(got.grid.mean()) <= 1
