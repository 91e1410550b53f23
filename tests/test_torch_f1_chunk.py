"""The fused factor sample's backward in chunks, and the line gradients
through the row scatter (K3 on the card), against JAX.

* With both packages' _PROD_BWD_CHUNK lowered to 64 (monkeypatched; JAX
  traced afresh, so that its chunked fori_loop branch runs), 300 samples
  on a 12x10 plane and a 9-long line of R = 4 (coordinates drawn from a
  seed, some exactly on the border and some past it): the port's value
  and all five cotangents equal JAX's, and the port's unchunked call,
  within 1e-5 of each leaf's largest value, for every set of inputs the
  trainers ask gradients of (everything; the factors alone, TensoRF's
  detached coordinates; the coordinates alone, test-time pose
  optimisation's frozen field).
* sample_line's value and gradients equal JAX's sample_line_packed at the
  same tolerance.
* The backward calls scatter_add_rows 2 x ceil(N / chunk) times (a plane
  and a line scatter a chunk), once for sample_line, and never when only
  the coordinates need gradients; the package keeps no one-hot helper,
  and no tensor the backward makes grows as samples x line length (every
  tensor it allocates is recorded by a dispatch mode).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from joint_tensorf_tpu.ops import sampling as jsampling
from joint_tensorf_tpu_torch.ops import sampling
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

N = 300
CHUNK = 64


def _inputs(H=12, W=10, D=9, R=4, n=N):
    rng = np.random.default_rng(16)
    plane = rng.standard_normal((H, W, R)).astype(np.float32)
    line = rng.standard_normal((D, R)).astype(np.float32)
    u, v, w = (rng.uniform(-1.1, 1.1, n).astype(np.float32)
               for _ in range(3))
    # exactly on each face, and past it: the clamps and the border masks
    for c in (u, v, w):
        c[:4] = [-1.0, 1.0, -1.1, 1.1]
        c[150:152] = [-1.0, 1.0]
    g = rng.standard_normal((n, R)).astype(np.float32)
    return (plane, line, u, v, w), g


def _jax_prod(args, g):
    """JAX's value and five cotangents, traced afresh (the chunk constant
    is read at trace time)."""
    jargs = tuple(jnp.asarray(a) for a in args)

    def loss(*a):
        out = jsampling.sample_planeline_prod(*a)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jargs)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_prod(args, g, need):
    ts = [torch.as_tensor(a).requires_grad_(bool(n))
          for a, n in zip(args, need)]
    out = sampling.sample_planeline_prod(*ts)
    (out * torch.as_tensor(g)).sum().backward()
    return out.detach().numpy(), [None if t.grad is None else t.grad.numpy()
                                  for t in ts]


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


# everything (BAT); the factors alone (TensoRF: detached coordinates);
# the coordinates alone (test-time pose optimisation: a frozen field)
NEEDS = {"all": (1, 1, 1, 1, 1), "factors": (1, 1, 0, 0, 0),
         "coords": (0, 0, 1, 1, 1)}
NAMES = ("plane", "line", "u", "v", "w")


@pytest.mark.parametrize("need", list(NEEDS))
def test_chunked_backward_matches_jax_and_unchunked(monkeypatch, need):
    args, g = _inputs()
    want_unchunked = _port_prod(args, g, NEEDS[need])
    monkeypatch.setattr(jsampling, "_PROD_BWD_CHUNK", CHUNK)
    monkeypatch.setattr(sampling, "_PROD_BWD_CHUNK", CHUNK)
    j_out, j_grads = _jax_prod(args, g)
    out, grads = _port_prod(args, g, NEEDS[need])
    _close(out, j_out, "value")
    _close(out, want_unchunked[0], "value (unchunked)")
    for name, n, got, want, ref in zip(NAMES, NEEDS[need], grads, j_grads,
                                       want_unchunked[1]):
        if not n:
            assert got is None, name
            continue
        _close(got, want, name)
        _close(got, ref, f"{name} (unchunked)")
    if NEEDS[need][2]:
        # the border masks: a coordinate past a face gets no gradient
        assert np.all(grads[2][[2, 3]] == 0)


def test_sample_line_matches_jax():
    (_, line, _, _, w), g = _inputs()

    def loss(l, ww):
        out = jsampling.sample_line_packed(l, ww)
        return jnp.sum(out * g), out

    (_, j_out), (j_dl, j_dw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(line),
                                            jnp.asarray(w))
    tl = torch.as_tensor(line).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    out = sampling.sample_line(tl, tw)
    (out * torch.as_tensor(g)).sum().backward()
    _close(out.detach().numpy(), np.asarray(j_out), "value")
    _close(tl.grad.numpy(), np.asarray(j_dl), "line")
    _close(tw.grad.numpy(), np.asarray(j_dw), "w")


class _Count:
    def __init__(self, monkeypatch):
        self.n = 0
        real = sampling.scatter_add_rows

        def counted(*a):
            self.n += 1
            return real(*a)
        monkeypatch.setattr(sampling, "scatter_add_rows", counted)


@pytest.mark.parametrize("chunk", [CHUNK, 100, N, 1 << 20])
@pytest.mark.parametrize("need", list(NEEDS))
def test_scatter_calls_per_backward(monkeypatch, chunk, need):
    monkeypatch.setattr(sampling, "_PROD_BWD_CHUNK", chunk)
    count = _Count(monkeypatch)
    args, g = _inputs()
    _port_prod(args, g, NEEDS[need])
    want = 0 if need == "coords" else 2 * math.ceil(N / chunk)
    assert count.n == want


def test_cpu_route_counts_and_notes_no_launch():
    """On the CPU the scatters are index_add_: no K3 launch is counted and
    no launch shape noted (cuda_build.SCATTER_SHAPES)."""
    from joint_tensorf_tpu_torch.ops import cuda_build

    cuda_build.reset_launches()
    args, g = _inputs()
    _port_prod(args, g, NEEDS["all"])
    assert cuda_build.LAUNCHES["scatter_add_rows"] == 0
    assert cuda_build.SCATTER_SHAPES == {}


def test_sample_line_scatters_once_and_not_when_frozen(monkeypatch):
    count = _Count(monkeypatch)
    (_, line, _, _, w), g = _inputs()
    tl = torch.as_tensor(line).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    (sampling.sample_line(tl, tw) * torch.as_tensor(g)).sum().backward()
    assert count.n == 1
    count.n = 0
    frozen = torch.as_tensor(line)
    tw.grad = None
    (sampling.sample_line(frozen, tw) * torch.as_tensor(g)).sum().backward()
    assert count.n == 0 and tw.grad is not None


class _Largest(TorchDispatchMode):
    """The most elements of any tensor an op returns while active."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("fn", ["prod", "line"])
def test_no_samples_by_line_length_tensor(monkeypatch, fn):
    """On a 200-long line with R = 2 a one-hot of even one 64-sample chunk
    (64 x 200) holds more elements than any tensor the scatters need (the
    [300, 8] plane rows, the [10 * 12, 8] packed plane): the backward
    allocates nothing that large."""
    assert not hasattr(sampling, "_scatter_rows_matmul")
    monkeypatch.setattr(sampling, "_PROD_BWD_CHUNK", CHUNK)
    (plane, line, u, v, w), g = _inputs(D=200, R=2)
    ts = [torch.as_tensor(a).requires_grad_(True)
          for a in (plane, line, u, v, w)]
    out = (sampling.sample_planeline_prod(*ts) if fn == "prod"
           else sampling.sample_line(ts[1], ts[4]))
    loss = (out * torch.as_tensor(g)).sum()
    largest = _Largest()
    with largest:
        loss.backward()
    assert ts[1].grad is not None and ts[4].grad is not None
    assert largest.numel < CHUNK * 200, largest.numel
