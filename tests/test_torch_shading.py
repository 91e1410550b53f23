"""PyTorch port vs JAX: every shading head and the SH bases.

* eval_sh_bases at degrees 0-4: values and the gradient with respect to
  the directions, rtol 1e-5;
* each of the ten heads (MLP_Fea, MLP_Fea4, MLP_Fea_WeakView,
  MLP_Fea_WeakView_Density, MLP_PE, MLP, MLP_Albedo, GaRF, SH, RGB) with
  JAX's initial weights copied into the port's head by its JAX tree path,
  at two progress values: the output (both outputs of the density head)
  and the gradients of a weighted sum with respect to the points, view
  directions, features and every weight, rtol 1e-5 (atol 1e-6 of each
  array's largest entry, for the entries near zero);
* the port's parameter names are the heads' JAX tree paths, and a head's
  dims follow its config (the density head's layer 2 is hidden + 1 wide;
  SH and RGB hold no parameter);
* the RGB head refuses any app_dim but 3, as JAX's asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_tensorf_tpu.models import shading as jshading
from joint_tensorf_tpu.ops import sh as jsh
from joint_tensorf_tpu_torch.models import shading
from joint_tensorf_tpu_torch.ops import sh
from joint_tensorf_tpu_torch.utils import setup_torch
from joint_tensorf_tpu_torch.utils.tree import flatten

setup_torch()

N, APP_DIM, VIEW_PE, POS_PE, FEA_PE, HIDDEN = 37, 27, 2, 3, 2, 16


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()) + 1e-12,
                               err_msg=what)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    vd = rng.normal(size=(N, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    feat = rng.normal(size=(N, APP_DIM)).astype(np.float32) * 0.5
    return pts, vd, feat


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_bases_matches_jax(deg):
    _, vd, _ = _inputs(deg)
    w = np.random.default_rng(9).normal(size=((deg + 1) ** 2,)).astype(
        np.float32)

    def jf(d):
        b = jsh.eval_sh_bases(deg, d)
        return jnp.sum(b * w), b

    (_, want), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(vd)
    d = torch.tensor(vd, requires_grad=True)
    got = sh.eval_sh_bases(deg, d)
    assert got.shape == (N, (deg + 1) ** 2)
    _close(got.detach().numpy(), want, f"bases deg {deg}")
    g = (torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), [d])[0]
         if got.requires_grad else torch.zeros((N, 3)))  # deg 0: constant
    _close(g.numpy(), jg, f"gradient deg {deg}")


def test_eval_sh_bases_refuses_degree_5():
    with pytest.raises(ValueError):
        sh.eval_sh_bases(5, torch.zeros((2, 3)))


def _app_dim(name):
    return 3 if name == "RGB" else APP_DIM


@pytest.mark.parametrize("progress", [(1.0, 1.0), (0.4, 0.7)])
@pytest.mark.parametrize("name", shading.HEAD_NAMES)
def test_head_matches_jax(name, progress):
    app_dim = _app_dim(name)
    jhead = jshading.make_shading_head(name, app_dim, VIEW_PE, POS_PE,
                                       FEA_PE, HIDDEN)
    params = jhead.init(jax.random.PRNGKey(3))
    head = shading.make_head(name, app_dim, VIEW_PE, POS_PE, FEA_PE, HIDDEN,
                             generator=torch.Generator().manual_seed(0))
    leaves = {k: np.array(v) for k, v in flatten(params).items()}
    assert {k: v.shape for k, v in leaves.items()} == {
        k: tuple(p.shape) for k, p in head.named_parameters()}
    head.load_state_dict({k: torch.as_tensor(v) for k, v in leaves.items()})
    assert head.predicts_density == jhead.predicts_density
    pts, vd, feat = _inputs(1)
    feat = feat[:, :app_dim]
    vp, fp = progress
    w_rgb = np.random.default_rng(2).normal(size=3).astype(np.float32)

    def jf(p, x, v, f):
        out = jhead.apply(p, x, v, f, vp, fp)
        rgb, sig = out if jhead.predicts_density else (out, None)
        loss = jnp.sum(rgb * w_rgb)
        if sig is not None:
            loss = loss + 0.3 * jnp.sum(sig)
        return loss, out

    (_, want), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True))(params, pts, vd, feat)
    ins = [torch.tensor(a, requires_grad=True) for a in (pts, vd, feat)]
    out = head(*ins, vp, fp)
    rgb, sig = out if head.predicts_density else (out, None)
    _close(rgb.detach().numpy(),
           want[0] if head.predicts_density else want, f"{name} rgb")
    loss = torch.sum(rgb * torch.as_tensor(w_rgb))
    if sig is not None:
        _close(sig.detach().numpy(), want[1], f"{name} density feature")
        loss = loss + 0.3 * torch.sum(sig)
    named = dict(head.named_parameters())
    grads = torch.autograd.grad(loss, ins + list(named.values()),
                                allow_unused=True)
    jgrads = dict(zip(("pts", "viewdirs", "features"), jg[1:]))
    jgrads.update(flatten(jg[0]))
    for k, g in zip(["pts", "viewdirs", "features"] + list(named), grads):
        want_g = np.asarray(jgrads[k])
        _close(np.zeros_like(want_g) if g is None else g.numpy(), want_g,
               f"{name} gradient of {k}")
    if name == "MLP_PE":        # the only head that reads the points
        assert np.abs(np.asarray(jgrads["pts"])).max() > 0


def test_head_trees_and_widths():
    def names(name):
        return sorted(k for k, _ in shading.make_head(
            name, _app_dim(name), VIEW_PE, POS_PE, FEA_PE,
            HIDDEN).named_parameters())

    assert names("MLP_Fea4") == sorted(
        f"layers.{i}.{k}" for i in range(4) for k in "wb")
    for name in ("MLP_Fea_WeakView", "MLP_Fea_WeakView_Density", "MLP_PE",
                 "MLP", "MLP_Albedo"):
        assert names(name) == sorted(f"layer{i}.{k}" for i in (1, 2, 3)
                                     for k in "wb"), name
    assert names("GaRF") == sorted(
        f"{layer}.{k}" for layer in ("fea_gauss", "view_gauss", "layer1",
                                     "layer2", "layer3") for k in "wb")
    assert names("SH") == names("RGB") == []
    dens = shading.make_head("MLP_Fea_WeakView_Density", APP_DIM, VIEW_PE,
                             POS_PE, FEA_PE, HIDDEN)
    assert dens.layer2.w.shape == (HIDDEN, HIDDEN + 1)


def test_rgb_head_needs_app_dim_3():
    with pytest.raises(AssertionError):
        jshading.make_shading_head("RGB", APP_DIM, VIEW_PE, POS_PE, FEA_PE,
                                   HIDDEN)
    with pytest.raises(ValueError, match="app_dim 3"):
        shading.make_head("RGB", APP_DIM, VIEW_PE, POS_PE, FEA_PE, HIDDEN)
