"""PyTorch port vs JAX: the fused plane x line factor sample with its five
gradients, and kernel K3's plain version (the plane-gradient row scatter)
against the TPU kernel it replaces (B4, in interpret mode on the CPU).

Tolerances: forward atol 1e-6 (same float32 arithmetic); gradients
rtol 1e-5 / atol 1e-5 (scatter-adds sum in another order on each side);
scatters rtol/atol 1e-5 (B4's one-hot matmul sums in sorted-block order).
The kernel itself is held against this plain version on the card by
tests/test_torch_kernels_cuda.py.

The summed density sample's plain version (K6's, sample_planeline_prod_sum
on a CPU tensor) on a plain field, a blurred one (the blur inside the
graph) and a comp-layout rank's block (widths 8 / 3 / 5, coordinates past
the box as L2G's warped points give): with a live mask it equals the sum
of sample_planeline_prod bit for bit at the live slots and is 0 at the
dead ones; its factor and coordinate gradients equal the masked sum's bit
for bit, and a cotangent on the dead slots alone gives gradients that are
exactly 0.
The concatenated appearance sample's plain version (K7's,
sample_planeline_prod_cat on a CPU tensor) on the same three fields: the
three fused samples and their cat, bit for bit in value and every
gradient; its scatters index_add_, none with frozen factors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_tensorf_tpu.ops import sampling as jsampling
from joint_tensorf_tpu.ops.segment_scatter import (BLOCK_ROWS,
                                                   scatter_add_rows as jscatter)
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import blur as blur_ops
from joint_tensorf_tpu_torch.ops import sampling, segment_scatter
from joint_tensorf_tpu_torch.ops.kernels import gaussian_kernel
from joint_tensorf_tpu_torch.ops.sampling import sample_planeline_prod
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()


def _prod_inputs():
    rng = np.random.default_rng(0)
    plane = rng.standard_normal((9, 11, 5)).astype(np.float32)
    line = rng.standard_normal((7, 5)).astype(np.float32)
    u, v, w = (rng.uniform(-1.2, 1.2, 300).astype(np.float32)
               for _ in range(3))
    # samples on the border and past it exercise the clamps and the masks
    # of the coordinate gradients (ops/sampling.py:390-395)
    for c in (u, v, w):
        c[:4] = [-1.0, 1.0, -1.3, 1.3]
    g = rng.standard_normal((300, 5)).astype(np.float32)
    return plane, line, u, v, w, g


@pytest.mark.parametrize("impl", ["xla", "segsum"])
def test_sample_planeline_prod_and_grads(impl):
    plane, line, u, v, w, g = _prod_inputs()

    def jloss(*a):
        return jnp.sum(jsampling.sample_planeline_prod(*a) * g)

    jargs = tuple(jnp.asarray(a) for a in (plane, line, u, v, w))
    want_out = np.asarray(jsampling.sample_planeline_prod(*jargs))
    jsampling.set_plane_scatter_impl(impl)
    try:
        want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)
    finally:
        jsampling.set_plane_scatter_impl("xla")

    targs = [torch.as_tensor(a).requires_grad_(True)
             for a in (plane, line, u, v, w)]
    out = sample_planeline_prod(*targs)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-6)
    (out * torch.as_tensor(g)).sum().backward()
    for name, t, ref in zip(("plane", "line", "u", "v", "w"), targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the masks zero the coordinate gradients of clamped samples
    assert np.all(targs[2].grad.numpy()[[2, 3]] == 0)


@pytest.mark.parametrize("n,rows,c", [
    (3000, 900, 64),          # duplicates, rows not a multiple of a block
    (300, 3000, 16),          # mostly-empty destination
])
def test_scatter_plain_matches_b4(n, rows, c):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, rows, size=n)
    upd = rng.standard_normal((n, c)).astype(np.float32)
    want = np.asarray(jscatter(jnp.asarray(idx, jnp.int32), jnp.asarray(upd),
                               rows, interpret=True))
    got = segment_scatter.scatter_add_rows(torch.as_tensor(idx),
                                           torch.as_tensor(upd), rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_scatter_plain_hot_rows_and_empty_blocks():
    """Every update lands on two rows of one block; the rest stays zero."""
    rng = np.random.default_rng(2)
    n, rows, c = 5000, 4 * BLOCK_ROWS, 32
    idx = rng.choice([BLOCK_ROWS + 3, BLOCK_ROWS + 4], size=n)
    upd = rng.standard_normal((n, c)).astype(np.float32)
    want = np.asarray(jscatter(jnp.asarray(idx, jnp.int32), jnp.asarray(upd),
                               rows, interpret=True))
    got = segment_scatter.scatter_add_rows(torch.as_tensor(idx),
                                           torch.as_tensor(upd), rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.count_nonzero(np.abs(got).sum(-1)) == 2


# ----------------------------------------- the summed density sample (K6)
def _density_case(kind):
    """(leaves, factors(leaves) -> (planes, lines), coords, live) for a
    field at res (9, 11, 7): plain leaves, or blurred inside the graph, or
    a comp rank's block of components (8 / 3 / 5) with coordinates past
    the box; live a prefix of each of 40 rays' 30 slots, and scattered
    slots, as compaction and the box gate leave it."""
    gen = torch.Generator().manual_seed(11)
    res = (9, 11, 7)
    ranks = (8, 3, 5) if kind == "comp" else (4, 4, 4)
    leaves = []
    for (m0, m1, vec), r in zip(vm.AXES, ranks):
        leaves.append(torch.randn((res[m1], res[m0], r), generator=gen))
        leaves.append(torch.randn((res[vec], r), generator=gen))
    leaves = [t.requires_grad_(True) for t in leaves]
    reach = 1.3 if kind == "comp" else 1.0
    coords = [(torch.rand((1200,), generator=gen) * 2 - 1) * reach
              for _ in range(3)]
    for c in coords:                  # on the faces and past them
        c[:4] = torch.tensor([-1.0, 1.0, -1.3, 1.3])
    coords = [c.requires_grad_(True) for c in coords]
    n_live = torch.randint(0, 31, (40, 1), generator=gen)
    live = (torch.arange(30)[None] < n_live).reshape(-1)
    live[::7] = True
    live[:4] = True

    def factors(leaves):
        planes, lines = list(leaves[0::2]), list(leaves[1::2])
        if kind == "blurred":
            k = gaussian_kernel(torch.tensor(1.5), 5)
            mats = vm.make_blur_mats(k, res)
            planes = [blur_ops.blur_plane(p, mats[p.shape[0]],
                                          mats[p.shape[1]]) for p in planes]
            lines = [blur_ops.blur_line(ln, mats[ln.shape[0]])
                     for ln in lines]
        return planes, lines

    return leaves, factors, coords, live


def _masked_sum(planes, lines, coords, live):
    """Today's arithmetic, spelt out: the sum of sample_planeline_prod over
    R and the axes, then 0 at the dead slots."""
    sigma = torch.zeros_like(coords[0])
    for plane, line, (a, b, c) in zip(planes, lines, vm.AXES):
        prod = sample_planeline_prod(plane, line, coords[a], coords[b],
                                     coords[c])
        sigma = sigma + torch.sum(prod, dim=-1)
    return torch.where(live, sigma, torch.zeros_like(sigma))


@pytest.mark.parametrize("kind", ["plain", "blurred", "comp"])
def test_density_sum_plain_is_the_masked_sum(kind):
    leaves, factors, coords, live = _density_case(kind)
    got = sampling.sample_planeline_prod_sum(*factors(leaves), coords,
                                             vm.AXES, live)
    want = _masked_sum(*factors(leaves), coords, live)
    assert torch.equal(got, want)
    assert torch.count_nonzero(got[~live]) == 0
    assert torch.count_nonzero(got[live]) == int(live.sum())
    whole = _masked_sum(*factors(leaves), coords, torch.ones_like(live))
    assert torch.equal(got[live], whole[live])
    everyone = sampling.sample_planeline_prod_sum(*factors(leaves), coords,
                                                  vm.AXES)
    assert torch.equal(everyone, whole)


@pytest.mark.parametrize("kind", ["plain", "blurred", "comp"])
def test_density_sum_plain_gradients(kind):
    leaves, factors, coords, live = _density_case(kind)
    inputs = leaves + coords
    cot = torch.randn(coords[0].shape, generator=torch.Generator()
                      .manual_seed(12))
    got = torch.autograd.grad((sampling.sample_planeline_prod_sum(
        *factors(leaves), coords, vm.AXES, live) * cot).sum(), inputs)
    want = torch.autograd.grad(
        (_masked_sum(*factors(leaves), coords, live) * cot).sum(), inputs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(torch.count_nonzero(a) > 0 for a in got)
    # the dead slots contribute nothing: a cotangent on them alone
    dead = torch.autograd.grad((sampling.sample_planeline_prod_sum(
        *factors(leaves), coords, vm.AXES, live)
        * torch.where(live, 0.0, cot)).sum(), inputs)
    assert all(torch.count_nonzero(a) == 0 for a in dead)
    # and the live slots' gradients are the unmasked sum's at live slots
    whole = torch.autograd.grad((_masked_sum(
        *factors(leaves), coords, torch.ones_like(live))
        * torch.where(live, cot, 0.0)).sum(), inputs)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def test_density_sum_plain_asks_only_for_what_is_needed(monkeypatch):
    """Frozen factors: no row scatter; detached coordinates: no coordinate
    gradients; the plain version's scatters are index_add_ (K6's plain
    version), never scatter_add_rows (K3's)."""
    leaves, factors, coords, live = _density_case("plain")
    calls = {"k3": 0, "rows": 0}
    real_rows = sampling._index_add_rows

    def k3(*a):
        calls["k3"] += 1
        return segment_scatter.scatter_add_rows(*a)

    def rows(*a):
        calls["rows"] += 1
        return real_rows(*a)

    monkeypatch.setattr(sampling, "scatter_add_rows", k3)
    monkeypatch.setattr(sampling, "_index_add_rows", rows)
    frozen = [t.detach() for t in leaves]
    out = sampling.sample_planeline_prod_sum(*factors(frozen), coords,
                                             vm.AXES, live)
    g = torch.autograd.grad(out.sum(), coords)
    assert calls == {"k3": 0, "rows": 0}
    assert all(torch.count_nonzero(a) > 0 for a in g)
    out = sampling.sample_planeline_prod_sum(
        *factors(leaves), [c.detach() for c in coords], vm.AXES, live)
    g = torch.autograd.grad(out.sum(), leaves)
    assert calls == {"k3": 0, "rows": 6}
    assert all(torch.count_nonzero(a) > 0 for a in g)


def _three_samples(planes, lines, coords):
    """Today's appearance arithmetic, spelt out: sample_planeline_prod of
    each axis, concatenated."""
    return torch.cat([sample_planeline_prod(plane, line, coords[a],
                                            coords[b], coords[c])
                      for plane, line, (a, b, c) in zip(planes, lines,
                                                        vm.AXES)], dim=-1)


@pytest.mark.parametrize("kind", ["plain", "blurred", "comp"])
def test_app_cat_plain_is_the_three_samples(kind):
    """The concatenated appearance sample's plain version (K7's,
    sample_planeline_prod_cat on a CPU tensor) equals the three fused
    samples and their cat bit for bit, in value and in every factor and
    coordinate gradient (the comp block's unequal widths 8 / 3 / 5
    included)."""
    leaves, factors, coords, _ = _density_case(kind)
    inputs = leaves + coords
    got = sampling.sample_planeline_prod_cat(*factors(leaves), coords,
                                             vm.AXES)
    want = _three_samples(*factors(leaves), coords)
    assert got.shape == (1200, sum(p.shape[-1] for p in leaves[0::2]))
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(13))
    got_g = torch.autograd.grad((got * cot).sum(), inputs)
    want_g = torch.autograd.grad((want * cot).sum(), inputs)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)
    assert all(torch.count_nonzero(a) > 0 for a in got_g)


def test_app_cat_plain_asks_only_for_what_is_needed(monkeypatch):
    """Frozen factors: no row scatter; detached coordinates: no coordinate
    gradients; the plain version's scatters are index_add_ (K7's plain
    version), never scatter_add_rows (K3's)."""
    leaves, factors, coords, _ = _density_case("plain")
    calls = {"k3": 0, "rows": 0}
    real_rows = sampling._index_add_rows

    def k3(*a):
        calls["k3"] += 1
        return segment_scatter.scatter_add_rows(*a)

    def rows(*a):
        calls["rows"] += 1
        return real_rows(*a)

    monkeypatch.setattr(sampling, "scatter_add_rows", k3)
    monkeypatch.setattr(sampling, "_index_add_rows", rows)
    frozen = [t.detach() for t in leaves]
    out = sampling.sample_planeline_prod_cat(*factors(frozen), coords,
                                             vm.AXES)
    g = torch.autograd.grad(out.sum(), coords)
    assert calls == {"k3": 0, "rows": 0}
    assert all(torch.count_nonzero(a) > 0 for a in g)
    out = sampling.sample_planeline_prod_cat(
        *factors(leaves), [c.detach() for c in coords], vm.AXES)
    g = torch.autograd.grad(out.sum(), leaves)
    assert calls == {"k3": 0, "rows": 6}
    assert all(torch.count_nonzero(a) > 0 for a in g)
