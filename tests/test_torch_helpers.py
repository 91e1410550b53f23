"""PyTorch port vs JAX: the JAX package's small public helpers that no
entry point of either package calls, on the same numpy inputs.

* ops/composite: raw2alpha; exclusive_cumprod's values and its
  division-free gradient, finite at alpha == 1.0 exactly (one_minus ==
  1e-10), and under JTF_CUMPROD_AUTODIFF=1 autograd's cumprod as JAX's
  autodiff; composite_weights (JAX's weight-level ``composite``) with and
  without acc_last_dir;
* ops/kernels: batch_gaussian_kernel and discrete_gaussian_kernel (an
  impulse at t = 0, no overflow at large t, an even size refused);
* geometry/lie: taylor_C, so3_to_SO3 and its Jacobian, at w = 0 too;
  geometry/rays: img2cam;
* models/alpha_mask: pack_neighborhoods, bit for bit;
* render/renderer: sample_ray with JAX's jitter draws;
* models/vm: coord_axes from either form;
* train/losses: soft_edge_render_loss with NaN targets.

Tolerances: rtol 1e-5 and atol 1e-6 in float32; exact for the packed
mask, the booleans and the kernels' host computation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_tensorf_tpu.geometry import lie as jlie
from joint_tensorf_tpu.geometry import rays as jrays
from joint_tensorf_tpu.models import alpha_mask as jam
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.ops import composite as jcomp
from joint_tensorf_tpu.ops import kernels as jkern
from joint_tensorf_tpu.render import renderer as jrend
from joint_tensorf_tpu.train import losses as jloss
from joint_tensorf_tpu_torch.geometry import lie, rays
from joint_tensorf_tpu_torch.models import alpha_mask as am
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import composite, kernels
from joint_tensorf_tpu_torch.render import renderer
from joint_tensorf_tpu_torch.train import losses
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _alpha_inputs(seed=0, n=6, s=40):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0, 30, (n, s)).astype(np.float32)
    sigma[0, 5] = 0.0
    dists = rng.uniform(0, 0.05, (n, s)).astype(np.float32)
    return sigma, dists


def test_raw2alpha_matches_jax():
    sigma, dists = _alpha_inputs()
    got = composite.raw2alpha(torch.tensor(sigma), torch.tensor(dists))
    want = jcomp.raw2alpha(jnp.asarray(sigma), jnp.asarray(dists))
    assert got[2].shape == (6, 1)
    for a, b in zip(got, want, strict=True):
        _close(a.numpy(), b)


@pytest.mark.parametrize("autodiff", ["0", "1"])
def test_exclusive_cumprod_gradient_at_saturation(monkeypatch, autodiff):
    """alpha == 1.0 exactly gives one_minus == 1e-10: the analytic
    backward stays finite and equals JAX's, and the autodiff switch
    matches JAX's autodiff."""
    monkeypatch.setenv("JTF_CUMPROD_AUTODIFF", autodiff)
    rng = np.random.default_rng(1)
    alpha = rng.uniform(0, 0.6, (5, 33)).astype(np.float32)
    alpha[0, 7] = 1.0
    alpha[1, ::4] = 1.0
    alpha[2] = 1.0
    om = (1.0 - alpha + 1e-10).astype(np.float32)
    dT = rng.standard_normal(om.shape).astype(np.float32)

    def loss(x):
        return jnp.sum(jcomp.exclusive_cumprod(x) * dT)

    jT = jcomp.exclusive_cumprod(jnp.asarray(om))
    jg = jax.grad(loss)(jnp.asarray(om))
    t = torch.tensor(om, requires_grad=True)
    T = composite.exclusive_cumprod(t)
    torch.sum(T * torch.tensor(dT)).backward()
    _close(T.detach().numpy(), jT)
    assert torch.isfinite(t.grad).all()
    scale = max(1.0, float(np.abs(np.asarray(jg)).max()))
    _close(t.grad.numpy(), jg, atol=1e-6 * scale)
    # the last one_minus enters no T_excl
    assert np.all(t.grad.numpy()[:, -1] == 0)


@pytest.mark.parametrize("acc_last", [False, True])
def test_composite_weights_matches_jax(acc_last):
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 0.1, (7, 20)).astype(np.float32)
    rgb = rng.uniform(0, 1, (7, 20, 3)).astype(np.float32)
    z = np.cumsum(rng.uniform(0, 0.1, (7, 20)), -1).astype(np.float32)
    last = rng.uniform(-1, 1, 7).astype(np.float32) if acc_last else None
    got = composite.composite_weights(
        torch.tensor(w), torch.tensor(rgb), torch.tensor(z),
        None if last is None else torch.tensor(last))
    want = jcomp.composite(jnp.asarray(w), jnp.asarray(rgb), jnp.asarray(z),
                           None if last is None else jnp.asarray(last))
    for a, b in zip(got, want, strict=True):
        _close(a.numpy(), b)


def test_batch_gaussian_kernel_matches_jax():
    sig = np.array([0.0, 0.3, 1.7, 12.0], np.float32)
    for K in (8, 15):
        _close(kernels.batch_gaussian_kernel(sig, K).numpy(),
               jkern.batch_gaussian_kernel(sig, K))


@pytest.mark.parametrize("t", [0.0, 0.7, 4.0, 900.0])
def test_discrete_gaussian_kernel_matches_jax(t):
    got = kernels.discrete_gaussian_kernel(t, 9)
    want = np.asarray(jkern.discrete_gaussian_kernel(t, 9))
    assert got.dtype == torch.float32 and got.shape == (9,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).all()
    if t == 0.0:
        np.testing.assert_array_equal(got.numpy(), np.eye(9)[4])


def test_discrete_gaussian_kernel_refuses_an_even_size():
    with pytest.raises(AssertionError):
        jkern.discrete_gaussian_kernel(1.0, 8)
    with pytest.raises(ValueError, match="odd"):
        kernels.discrete_gaussian_kernel(1.0, 8)


def test_taylor_C_matches_jax():
    x = np.linspace(-2.0, 2.0, 41).astype(np.float32)
    _close(lie.taylor_C(torch.tensor(x)).numpy(), jlie.taylor_C(x))
    _close(lie.taylor_C(torch.tensor(x), nth=4).numpy(),
           jlie.taylor_C(x, nth=4))


@pytest.mark.parametrize("zero", [False, True])
def test_so3_to_SO3_and_its_jacobian_match_jax(zero):
    """Values and d R / d w, at w = 0 (the series in theta^2 is smooth
    there) and at a few rotations."""
    rng = np.random.default_rng(3)
    w = (np.zeros((4, 3)) if zero else rng.normal(size=(4, 3))).astype(
        np.float32)
    _close(lie.so3_to_SO3(torch.tensor(w)).numpy(),
           jlie.so3_to_SO3(jnp.asarray(w)))
    jj = jax.jacrev(jlie.so3_to_SO3)(jnp.asarray(w))
    pj = torch.autograd.functional.jacobian(lie.so3_to_SO3, torch.tensor(w))
    assert torch.isfinite(pj).all()
    _close(pj.numpy(), jj)


def test_img2cam_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 50, (2, 30, 3)).astype(np.float32)
    intr_inv = np.linalg.inv(rng.uniform(0.5, 2.0, (2, 3, 3))).astype(
        np.float32)
    _close(rays.img2cam(torch.tensor(X), torch.tensor(intr_inv)).numpy(),
           jrays.img2cam(jnp.asarray(X), jnp.asarray(intr_inv)))


@pytest.mark.parametrize("shape", [(5, 4, 3), (1, 2, 7), (6, 1, 1)])
def test_pack_neighborhoods_bitwise(shape):
    grid = (np.random.default_rng(5).uniform(size=shape) > 0.5).astype(
        np.float32)
    got = am.pack_neighborhoods(torch.tensor(grid))
    want = np.asarray(jam.pack_neighborhoods(jnp.asarray(grid)))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stratified", [False, True])
def test_sample_ray_with_jax_draws(stratified):
    rng = np.random.default_rng(6)
    n, S = 50, 24
    aabb = np.array([[-1.5, -1.2, -1.0], [1.5, 1.3, 1.1]], np.float32)
    centers = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    dirs = (-centers + rng.normal(size=(n, 3))).astype(np.float32)
    dirs[0, 1] = 0.0                            # an axis-parallel ray
    key = jax.random.PRNGKey(7)
    pts, z, inb = jrend.sample_ray(jnp.asarray(aabb), 0.05, S,
                                   jnp.asarray(centers), jnp.asarray(dirs),
                                   key, 2.0, 6.0, stratified)
    jitter = np.asarray(jax.random.uniform(key, (n, 1))) if stratified \
        else None
    got = renderer.sample_ray(
        torch.tensor(aabb), 0.05, S, torch.tensor(centers),
        torch.tensor(dirs), 2.0, 6.0, stratified,
        jitter=None if jitter is None else torch.tensor(jitter))
    assert got[0].shape == (n, S, 3)
    _close(got[0].numpy(), pts)
    _close(got[1].numpy(), z)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(inb))


def test_coord_axes_from_either_form():
    c = np.random.default_rng(8).uniform(-1, 1, (9, 3)).astype(np.float32)
    want = jvm.coord_axes(jnp.asarray(c))
    for form in (torch.tensor(c), tuple(torch.tensor(c).unbind(-1))):
        got = vm.coord_axes(form)
        assert len(got) == 3
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_soft_edge_render_loss_with_nan_targets():
    rng = np.random.default_rng(9)
    rgb = rng.uniform(0, 1, (2, 30, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 30, 3)).astype(np.float32)
    target[0, 3] = np.nan
    target[1, 7, 2] = np.nan
    mask = rng.uniform(0, 1, (2, 30)).astype(np.float32)
    got = losses.soft_edge_render_loss(torch.tensor(rgb),
                                       torch.tensor(target),
                                       torch.tensor(mask), 2.0, 0.5)
    want = jloss.soft_edge_render_loss(jnp.asarray(rgb), jnp.asarray(target),
                                       jnp.asarray(mask), 2.0, 0.5)
    assert np.isfinite(float(got))
    _close(float(got), float(want))
