"""PyTorch port vs JAX: the lane-packed dense grid (ops/lane_grid.py) and
vm.compute_lane_density_grid, the seven cases of tests/test_lane_grid.py
on the same numpy inputs through both packages.

* sample_lane_grid(pack_lane_grid(G)) against JAX's, and against the
  port's packed8 sampler (one function), at rtol / atol 1e-6 as JAX's test
  holds its own: random points past the box, z at the 31-cell block seams
  and the clamped edges, Z inside one block;
* its gradients w.r.t. G (through the fold) and the coordinates (the pose
  path) at rtol 1e-5 / atol 1e-6 (of the leaf's largest magnitude where
  it passes 1, _close; the same for every float32 comparison below), with samples exactly on the box's faces
  (x = +-1: JAX's jnp.clip gives half the gradient there) and exactly on
  interior cell faces (grids of 2^k + 1 cells, so the cell index is exact);
* the fold unpack_lane_grid_T against JAX's _pack_bwd and its streaming
  rewrite unpack_lane_grid_T at Z a multiple of 31, one more than one,
  Z <= 32 and several blocks;
* build_lane_grid_vm against pack_lane_grid of the dense grid and against
  JAX's, values and factor gradients, and compute_lane_density_grid
  against JAX's for VM (plain, component-wise, plane_feature2density,
  abs_components, blurred, convolve_plane_only) and CP; the comp layout
  raises;
* row_dtype "bfloat16": values and coordinate gradients against JAX's bf16
  rows (_close), the grid's gradient EXACTLY the float32 path's
  (the scatter never sees bf16) and within 1e-6 of JAX's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flatten_field

from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.ops import lane_grid as jlane
from joint_tensorf_tpu_torch.convert import field_from_numpy
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import densify, lane_grid
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    """rtol, and atol scaled by the leaf's largest magnitude where it
    passes 1: a float32 sum of terms of size s rounds by ~eps * s, so a
    gradient entry that cancels to near zero keeps an absolute error set
    by its terms, not by itself."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


def _setup(X=37, Y=29, Z=67, N=4096, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((X, Y, Z)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (N, 3)).astype(np.float32)
    return G, coords


def _port(G, coords, row_dtype="float32", grad=False):
    Gt = torch.tensor(G, requires_grad=grad)
    ct = torch.tensor(coords, requires_grad=grad)
    out = lane_grid.sample_lane_grid(lane_grid.pack_lane_grid(Gt), ct,
                                     G.shape[2], row_dtype)
    return out, Gt, ct


def _jax(G, coords, row_dtype="float32"):
    return np.asarray(jlane.sample_lane_grid(
        jlane.pack_lane_grid(jnp.asarray(G)), jnp.asarray(coords),
        G.shape[2], row_dtype))


def _packed8(G, coords):
    c = torch.tensor(coords)
    return densify.sample_packed_grid(densify.pack_corners(torch.tensor(G)),
                                      c.unbind(-1))


@pytest.mark.parametrize("case", ["random", "small_z"])
def test_matches_jax_and_packed8_values(case):
    G, coords = (_setup() if case == "random"
                 else _setup(X=16, Y=16, Z=9, N=777, seed=3))
    got = _port(G, coords)[0].numpy()
    np.testing.assert_allclose(got, _jax(G, coords), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, _packed8(G, coords).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_matches_at_block_boundaries():
    """z0 at the block seams and the clamped edges reads the halo entry,
    not the next block's start."""
    X, Y, Z = 8, 8, 96
    G = np.random.default_rng(1).standard_normal((X, Y, Z)).astype(
        np.float32)
    zs = np.array([30.3, 30.9, 31.1, 61.5, 62.0, 92.7, Z - 1.001, 0.0],
                  np.float32)
    zn = zs / (Z - 1) * 2.0 - 1.0
    coords = np.stack([np.full_like(zn, 0.21), np.full_like(zn, -0.4), zn],
                      axis=-1)
    got = _port(G, coords)[0].numpy()
    np.testing.assert_allclose(got, _jax(G, coords), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, _packed8(G, coords).numpy(), rtol=1e-6,
                               atol=1e-6)


def _face_coords(shape, n, seed):
    """Points inside and past the box, a few exactly on its faces (+-1),
    and a few exactly on interior cell faces of a grid with 2^k + 1 cells
    per axis (c = 2i / (size - 1) - 1 is exact)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    c[:6] = [[-1, 1, -1], [1, -1, 1], [1, 1, 1], [-1, -1, -1],
             [0.5, -1, 1], [1, 0.25, -1]]
    for a, size in enumerate(shape):
        i = rng.integers(1, size - 1, 24)
        c[6 + 24 * a:30 + 24 * a, a] = (2.0 * i / (size - 1) - 1.0)
    return c


@pytest.mark.parametrize("shape", [(37, 29, 67), (17, 9, 65)])
def test_gradients_match_jax(shape):
    """The grid's gradient (through the row gather's scatter and the fold)
    and the coordinates' (the pose path), faces included."""
    X, Y, Z = shape
    G = _setup(X, Y, Z, N=1, seed=2)[0]
    coords = _face_coords(shape, 512, 4)
    ds = np.random.default_rng(5).standard_normal(512).astype(np.float32)

    def f(g, c):
        return jnp.sum(jlane.sample_lane_grid(jlane.pack_lane_grid(g), c,
                                              Z) * ds)

    gj, cj = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(G),
                                                   jnp.asarray(coords))
    out, Gt, ct = _port(G, coords, grad=True)
    torch.sum(out * torch.tensor(ds)).backward()
    _close(Gt.grad.numpy(), gj)
    _close(ct.grad.numpy(), cj)
    # the packed8 sampler is the same function, gradients included
    G8 = torch.tensor(G, requires_grad=True)
    c8 = torch.tensor(coords, requires_grad=True)
    torch.sum(densify.sample_packed_grid(densify.pack_corners(G8),
                                         c8.unbind(-1))
              * torch.tensor(ds)).backward()
    _close(Gt.grad.numpy(), G8.grad.numpy())
    _close(ct.grad.numpy(), c8.grad.numpy())


@pytest.mark.parametrize("shape", [(7, 5, 62), (9, 6, 67), (4, 4, 13),
                                   (5, 3, 31 * 3 + 1), (3, 2, 1)])
def test_fold_matches_both_jax_forms(shape):
    rng = np.random.default_rng(sum(shape))
    Zb = lane_grid.n_blocks(shape[2])
    assert Zb == jlane.n_blocks(shape[2])
    dP = rng.standard_normal(shape[:2] + (Zb, 128)).astype(np.float32)
    got = lane_grid.unpack_lane_grid_T(shape, torch.tensor(dP)).numpy()
    assert got.shape == shape
    (ref,) = jlane._pack_bwd(shape, jnp.asarray(dP))
    _close(got, ref)
    _close(got, jlane.unpack_lane_grid_T(shape, jnp.asarray(dP)))
    # the fold is pack_lane_grid's backward, and the pack equals JAX's
    G = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                     requires_grad=True)
    P = lane_grid.pack_lane_grid(G)
    np.testing.assert_array_equal(
        P.detach().numpy(),
        np.asarray(jlane.pack_lane_grid(jnp.asarray(G.detach().numpy()))))
    P.backward(torch.tensor(dP))
    np.testing.assert_array_equal(G.grad.numpy(), got)


# ------------------------------------------------- the direct VM build
RES = (17, 23, 66)
AABB = [-1.5] * 3 + [1.5] * 3
TINY = dict(density_n_comp=(4, 3, 2), app_n_comp=(2, 2, 2), app_dim=4,
            hidden=8)
VARIANTS = {
    "plain": {},
    "component_wise_feature2density": dict(
        component_wise_feature2density=True, density_shift=-4.0),
    "plane_feature2density": dict(plane_feature2density=True,
                                  density_shift=-4.0),
    "abs_components": dict(abs_components=True),
    "blurred": {},
    "convolve_plane_only": dict(convolve_plane_only=True),
    "cp": dict(decomposition="CP", density_n_comp=(5, 5, 5),
               app_n_comp=(4, 4, 4)),
    "cp_component_wise": dict(decomposition="CP", density_n_comp=(5, 5, 5),
                              app_n_comp=(4, 4, 4), density_shift=-4.0,
                              component_wise_feature2density=True),
}
BLURRED = ("blurred", "convolve_plane_only", "abs_components", "cp")


def _blur_mats(res, torch_side: bool):
    k = jvm.c2f_kernel("uniform-gaussian", jnp.float32(0.3), 9,
                       jnp.float32(4.0))
    mats = jvm.make_blur_mats(k, res)
    if not torch_side:
        return mats
    return {L: torch.tensor(np.asarray(B)) for L, B in mats.items()}


def _factor_grads(field):
    return [p.grad.numpy() for p in list(field.density_planes)
            + list(field.density_lines)]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_lane_density_grid_matches_jax(name):
    kw = {**TINY, **VARIANTS[name]}
    jcfg, pcfg = jvm.VMConfig(**kw), vm.VMConfig(**kw)
    st = jvm.init_vm(jax.random.PRNGKey(7), jcfg, RES, AABB,
                     init_scale=0.5, init_bias=0.1)
    blurred = name in BLURRED
    jmats = _blur_mats(RES, False) if blurred else None
    want = jvm.compute_lane_density_grid(st, jcfg, blur_mats=jmats)
    dG = np.random.default_rng(8).standard_normal(want.shape).astype(
        np.float32)

    def loss(s):
        return jnp.sum(jvm.compute_lane_density_grid(s, jcfg, jmats) * dG)

    jg = jax.jit(jax.grad(loss))(st)
    field = field_from_numpy(flatten_field(st), pcfg)
    pmats = _blur_mats(RES, True) if blurred else None
    got = vm.compute_lane_density_grid(field, pcfg, blur_mats=pmats)
    assert got.shape == want.shape
    _close(got.detach().numpy(), want)
    torch.sum(got * torch.tensor(dG)).backward()
    want_g = list(jg.density_planes) + list(jg.density_lines)
    for a, b in zip(_factor_grads(field), want_g, strict=True):
        _close(a, b)
    # the direct build equals the pack of the dense grid (the port's own)
    field.zero_grad()
    ref = lane_grid.pack_lane_grid(
        vm.compute_density_grid(field, pcfg, blur_mats=pmats))
    _close(got.detach().numpy(), ref.detach().numpy())


def test_build_lane_grid_vm_matches_jax():
    """The factors straight into build_lane_grid_vm, gradients included."""
    rng = np.random.default_rng(9)
    X, Y, Z = 11, 7, 40
    R = (3, 2, 4)
    planes = [rng.standard_normal(s).astype(np.float32) for s in
              ((Y, X, R[0]), (Z, X, R[1]), (Z, Y, R[2]))]
    lines = [rng.standard_normal(s).astype(np.float32) for s in
             ((Z, R[0]), (Y, R[1]), (X, R[2]))]
    dG = rng.standard_normal((X, Y, lane_grid.n_blocks(Z), 128)).astype(
        np.float32)

    def loss(p, ln):
        return jnp.sum(jlane.build_lane_grid_vm(list(p), list(ln)) * dG)

    want = jlane.build_lane_grid_vm([jnp.asarray(p) for p in planes],
                                    [jnp.asarray(x) for x in lines])
    jgp, jgl = jax.grad(loss, argnums=(0, 1))(
        tuple(jnp.asarray(p) for p in planes),
        tuple(jnp.asarray(x) for x in lines))
    tp = [torch.tensor(p, requires_grad=True) for p in planes]
    tl = [torch.tensor(x, requires_grad=True) for x in lines]
    got = lane_grid.build_lane_grid_vm(tp, tl)
    _close(got.detach().numpy(), want)
    torch.sum(got * torch.tensor(dG)).backward()
    for t, w in zip(tp + tl, list(jgp) + list(jgl), strict=True):
        _close(t.grad.numpy(), w)


def test_comp_layout_raises():
    cfg = vm.VMConfig(**TINY)
    field = vm.init_vm(cfg, (9, 9, 9), torch.tensor(AABB),
                       torch.Generator().manual_seed(0))
    field.comp = types.SimpleNamespace(comp=2)
    with pytest.raises(ValueError, match="comp"):
        vm.compute_lane_density_grid(field, cfg)


# --------------------------------------------------------- bf16 row reads
def test_bf16_rows_match_jax_with_exact_f32_grid_gradient():
    G, coords = _setup(N=2048)
    d_out = np.random.default_rng(7).standard_normal(2048).astype(
        np.float32)
    Z = G.shape[2]

    def loss(P, c, dt):
        return jnp.sum(jlane.sample_lane_grid(P, c, Z, row_dtype=dt) * d_out)

    P = jlane.pack_lane_grid(jnp.asarray(G))
    jgP, jgc = jax.grad(loss, argnums=(0, 1))(P, jnp.asarray(coords),
                                              "bfloat16")
    got, grads = {}, {}
    for dt in ("float32", "bfloat16"):
        Pt = lane_grid.pack_lane_grid(torch.tensor(G)).requires_grad_(True)
        ct = torch.tensor(coords, requires_grad=True)
        out = lane_grid.sample_lane_grid(Pt, ct, Z, dt)
        torch.sum(out * torch.tensor(d_out)).backward()
        got[dt] = out.detach().numpy()
        grads[dt] = (Pt.grad.numpy(), ct.grad.numpy())
    _close(got["bfloat16"], _jax(G, coords, "bfloat16"))
    assert grads["bfloat16"][0].dtype == np.float32
    np.testing.assert_array_equal(grads["bfloat16"][0], grads["float32"][0])
    np.testing.assert_allclose(grads["bfloat16"][0], np.asarray(jgP),
                               rtol=1e-6, atol=1e-6)
    _close(grads["bfloat16"][1], jgc)
    # within bf16 quantisation of the float32 values
    np.testing.assert_allclose(got["bfloat16"], got["float32"], rtol=1e-2,
                               atol=1e-2)


def test_row_gather_scatters_once_at_128_channels(monkeypatch):
    """The backward is ONE row scatter of [N, 128] rows (K3 on the card)."""
    calls = []
    real = densify.scatter_add_rows

    def spy(idx, upd, n_rows):
        calls.append((tuple(upd.shape), n_rows))
        return real(idx, upd, n_rows)

    monkeypatch.setattr(densify, "scatter_add_rows", spy)
    G, coords = _setup(X=9, Y=8, Z=40, N=300)
    out, Gt, _ = _port(G, coords, grad=True)
    out.sum().backward()
    assert calls == [((300, 128), 9 * 8 * lane_grid.n_blocks(40))]
