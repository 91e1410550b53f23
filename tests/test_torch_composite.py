"""PyTorch port vs JAX: the compositor (kernels K1/K2's plain versions).

* thres = -inf against the TPU kernels B1/B2 (composite_pallas, interpret
  mode on the CPU), on unsaturated rays: atol 1e-5 / rtol 1e-4, since B1
  forms T as exp(cumsum(log u)) and the port as a running product.
* thres = 1e-6 against the JAX dense path (exclusive_cumprod + the
  weight > thres appearance gate), including rays with alpha == 1.0
  exactly: gradients must be finite and equal (atol 1e-5 / rtol 1e-4).
* S = 257 and S = 1000 (the last phase's rays) against the dense path in
  the same way.
The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_tensorf_tpu.ops import composite as jcomposite
from joint_tensorf_tpu.ops.pallas_kernels import composite_pallas
from joint_tensorf_tpu_torch.ops import composite as C
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()


def _inputs(n=12, s=40, saturate=False, seed=0):
    rng = np.random.default_rng(seed)
    alpha = (rng.random((n, s)) * 0.3).astype(np.float32)
    alpha[1, ::2] = 0.0                                  # transparent steps
    if saturate:
        alpha[2] = 1.0                                   # EXACTLY saturated
        alpha[3, ::3] = 1.0                              # T underflows to 0
        alpha[4, 5] = 0.9999999
        alpha[5] = 1e-7                                  # weights below thres
    rgb = rng.random((n, s, 3)).astype(np.float32)
    z = np.cumsum(rng.random((n, s)), -1).astype(np.float32)
    cots = (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, s)).astype(np.float32))
    return alpha, rgb, z, cots


def _port(alpha, rgb, z, cots, thres):
    ta, tr, tz = (torch.as_tensor(a).requires_grad_(True)
                  for a in (alpha, rgb, z))
    outs = C.composite(ta, tr, tz, thres)
    sum(torch.sum(o * torch.as_tensor(c)) for o, c in zip(outs, cots)
        ).backward()
    return [o.detach().numpy() for o in outs], \
        [t.grad.numpy() for t in (ta, tr, tz)]


def _jax(fn, alpha, rgb, z, cots):
    def loss(a, r, zz):
        return sum(jnp.sum(o * c) for o, c in zip(fn(a, r, zz), cots))

    outs = fn(alpha, rgb, z)
    grads = jax.grad(loss, argnums=(0, 1, 2))(alpha, rgb, z)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _compare(got, want):
    for name, a, b in zip(("rgb_map", "depth", "acc", "weights",
                           "d_alpha", "d_rgb", "d_z"),
                          got[0] + got[1], want[0] + want[1]):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_ungated_matches_pallas_b1_b2():
    alpha, rgb, z, cots = _inputs()
    want = _jax(composite_pallas, *(jnp.asarray(a) for a in (alpha, rgb, z)),
                cots)
    _compare(_port(alpha, rgb, z, cots, float("-inf")), want)


def _jax_dense_gated(alpha, rgb, z):
    """The JAX package's dense path (render/renderer.py:526-651)."""
    T = jcomposite.exclusive_cumprod(1.0 - alpha + 1e-10)
    w = alpha * T
    gate = w > 1e-6
    rgb_map = jnp.sum(w[..., None] * (rgb * gate[..., None]), axis=-2)
    return rgb_map, jnp.sum(w * z, -1), jnp.sum(w, -1), w


def test_gated_matches_jax_dense_path_with_saturated_rays():
    alpha, rgb, z, cots = _inputs(saturate=True, seed=1)
    want = _jax(_jax_dense_gated, *(jnp.asarray(a) for a in (alpha, rgb, z)),
                cots)
    got = _port(alpha, rgb, z, cots, 1e-6)
    _compare(got, want)
    # the gate is live: ray 5's weights are all below the threshold
    assert np.all(got[0][0][5] == 0)


@pytest.mark.parametrize("s", [257, 1000])
def test_gated_long_rays_match_jax_dense_path(s):
    """Rays as long as the last phase's (S = 1000) and just past a power of
    two, with alpha == 1.0 exactly on some; depths between the near and
    far planes."""
    rng = np.random.default_rng(s)
    n = 4
    alpha = (rng.random((n, s)) * min(0.3, 8.0 / s)).astype(np.float32)
    alpha[1] = 1.0                                       # EXACTLY saturated
    alpha[2, ::5] = 1.0
    rgb = rng.random((n, s, 3)).astype(np.float32)
    z = (2.0 + np.cumsum(rng.random((n, s)), -1) * (4.0 / s)).astype(
        np.float32)
    cots = (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, s)).astype(np.float32))
    want = _jax(_jax_dense_gated, *(jnp.asarray(a) for a in (alpha, rgb, z)),
                cots)
    _compare(_port(alpha, rgb, z, cots, 1e-6), want)
