"""PyTorch port vs JAX: the hybrid plane / line samples and the packed
aliases (ops/sampling.py).

* sample_plane_hybrid / sample_line_hybrid against JAX's on the same numpy
  inputs: values, the factor's gradient (ONE row scatter of [N, 4R] or
  [N, 2R] rows, K3 on the card, folded) and the coordinates' (autograd of
  the plain gather with the factor held constant, JAX's jax.vjp), at rtol
  1e-5 and atol 1e-6 of each leaf's largest magnitude where it passes 1,
  with samples exactly on the border (+-1: jnp.clip's half gradient) and
  exactly on interior cell faces (2^k + 1 cells, so the index is exact),
  and past the border;
* the backward makes one row scatter when the factor's gradient is asked
  for and none when only the coordinates' is (ctx.needs_input_grad);
* sample_plane_packed / sample_line_packed are the port's sample_plane /
  sample_line (one packed gather each): their values equal the hybrids'
  4-corner / 2-point gathers bit for bit, as JAX's test_ops pins its
  packed samplers against its plain ones, and JAX's within 1e-6; their
  gradients equal JAX's packed samplers', faces included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_tensorf_tpu.ops import sampling as jsamp
from joint_tensorf_tpu_torch.ops import sampling
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

H, W, D, R, N = 33, 17, 65, 6, 700


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * scale)


def _face(rng, size, n):
    """Normalised coordinates of exact interior cell faces."""
    return (2.0 * rng.integers(1, size - 1, n) / (size - 1) - 1.0).astype(
        np.float32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((H, W, R)).astype(np.float32)
    line = rng.standard_normal((D, R)).astype(np.float32)
    u, v, w = (rng.uniform(-1.2, 1.2, N).astype(np.float32)
               for _ in range(3))
    u[:4], v[:4], w[:4] = [-1, 1, 1, -1], [1, -1, 1, -1], [-1, 1, -1, 1]
    u[4:40], v[40:76], w[4:40] = _face(rng, W, 36), _face(rng, H, 36), \
        _face(rng, D, 36)
    g = rng.standard_normal((N, R)).astype(np.float32)
    return plane, line, u, v, w, g


def _t(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def test_plane_hybrid_matches_jax():
    plane, _, u, v, _, g = _inputs(1)

    def loss(p, uu, vv):
        return jnp.sum(jsamp.sample_plane_hybrid(p, uu, vv) * g)

    want = jsamp.sample_plane_hybrid(jnp.asarray(plane), jnp.asarray(u),
                                     jnp.asarray(v))
    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(plane), jnp.asarray(u), jnp.asarray(v))
    tp, tu, tv = _t(plane, u, v)
    got = sampling.sample_plane_hybrid(tp, tu, tv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    torch.sum(got * torch.tensor(g)).backward()
    for t, j in zip((tp, tu, tv), jg, strict=True):
        _close(t.grad.numpy(), j)
    # the border samples keep a coordinate gradient (jnp.clip gives them
    # half of it; _close above holds the port to that)
    assert np.all(np.asarray(jg[1])[:4] != 0)


def test_line_hybrid_matches_jax():
    _, line, _, _, w, g = _inputs(2)

    def loss(ln, ww):
        return jnp.sum(jsamp.sample_line_hybrid(ln, ww) * g)

    want = jsamp.sample_line_hybrid(jnp.asarray(line), jnp.asarray(w))
    jg = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(line),
                                                 jnp.asarray(w))
    tl, tw = _t(line, w)
    got = sampling.sample_line_hybrid(tl, tw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    torch.sum(got * torch.tensor(g)).backward()
    _close(tl.grad.numpy(), jg[0])
    _close(tw.grad.numpy(), jg[1])


def test_line_hybrid_with_every_sample_in_one_row():
    """Every sample on one line row: the heaviest collision the row
    scatter sees."""
    _, line, _, _, _, g = _inputs(3)
    w = np.full(N, 0.3125, np.float32)

    def loss(ln, ww):
        return jnp.sum(jsamp.sample_line_hybrid(ln, ww) * g)

    jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(line), jnp.asarray(w))
    tl, tw = _t(line, w)
    torch.sum(sampling.sample_line_hybrid(tl, tw) * torch.tensor(g)).backward()
    _close(tl.grad.numpy(), jg[0])
    _close(tw.grad.numpy(), jg[1])


@pytest.mark.parametrize("which", ["factor", "coords", "both"])
def test_backward_scatters_only_when_asked(monkeypatch, which):
    calls = []
    real = sampling.scatter_add_rows

    def spy(idx, upd, n_rows):
        calls.append((tuple(upd.shape), n_rows))
        return real(idx, upd, n_rows)

    monkeypatch.setattr(sampling, "scatter_add_rows", spy)
    plane, line, u, v, w, g = _inputs(4)
    tp, tl = (torch.tensor(a, requires_grad=which != "coords")
              for a in (plane, line))
    tu, tv, tw = (torch.tensor(a, requires_grad=which != "factor")
                  for a in (u, v, w))
    out = (sampling.sample_plane_hybrid(tp, tu, tv)
           + sampling.sample_line_hybrid(tl, tw))
    torch.sum(out * torch.tensor(g)).backward()
    want = [] if which == "coords" else [((N, 4 * R), H * W),
                                         ((N, 2 * R), D)]
    assert sorted(calls) == sorted(want)
    assert (tu.grad is None) == (which == "factor")
    assert (tp.grad is None) == (which == "coords")


def test_packed_aliases_are_the_plain_samplers():
    assert sampling.sample_plane_packed is sampling.sample_plane
    assert sampling.sample_line_packed is sampling.sample_line
    plane, line, u, v, w, g = _inputs(5)
    tp, tl, tu, tv, tw = (torch.tensor(a) for a in (plane, line, u, v, w))
    got_p = sampling.sample_plane_packed(tp, tu, tv).numpy()
    got_l = sampling.sample_line_packed(tl, tw).numpy()
    # the packed gather and the corner gathers: the same values bit for bit
    np.testing.assert_array_equal(
        got_p, sampling.sample_plane_hybrid(tp, tu, tv).numpy())
    np.testing.assert_array_equal(
        got_l, sampling.sample_line_hybrid(tl, tw).numpy())
    np.testing.assert_allclose(got_p, np.asarray(jsamp.sample_plane_packed(
        jnp.asarray(plane), jnp.asarray(u), jnp.asarray(v))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(got_l, np.asarray(jsamp.sample_line_packed(
        jnp.asarray(line), jnp.asarray(w))), rtol=1e-6, atol=1e-6)


def test_packed_alias_gradients_match_jax():
    plane, line, u, v, w, g = _inputs(6)

    def loss(p, ln, uu, vv, ww):
        return jnp.sum((jsamp.sample_plane_packed(p, uu, vv)
                        + jsamp.sample_line_packed(ln, ww)) * g)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (plane, line, u, v, w)))
    ts = _t(plane, line, u, v, w)
    out = (sampling.sample_plane_packed(ts[0], ts[2], ts[3])
           + sampling.sample_line_packed(ts[1], ts[4]))
    torch.sum(out * torch.tensor(g)).backward()
    for t, j in zip(ts, jg, strict=True):
        _close(t.grad.numpy(), j)
