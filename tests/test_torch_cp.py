"""PyTorch port vs JAX: the CP decomposition (BAT_CP / TensorCP).

* init_vm: no planes, lines [res of their axis, R] drawn as
  scale * N(0, 1) (signed, no bias), the basis [app comps[0], app_dim];
  resolution() read from the lines;
* the density feature (with and without the blur, with
  component_wise_feature2density) and the appearance feature (the line
  product times the basis) at 300 points against JAX's: rtol 1e-5, and
  their gradients with respect to the lines, the basis and the
  coordinates at 1e-4 of each one's largest entry;
* the dense grid (xr,yr,zr->xyz, blurred or not, component-wise) within
  1e-5 of its max, and the dense grid's sample equal to the factored one;
* density_L1 and the TV terms (the lines' TV x 1e-3) with gradients;
  vector_comp_diffs on a CP and a VM field, with gradients;
* upsample (atol 1e-6: the same matmuls summed in another order) and
  shrink (bit for bit) against JAX's, with empty plane lists;
* the alpha mask of a CP field (plain and component-wise) equal to JAX's,
  with its box;
* render_rays on a CP field (the dense grid and app_k asked for) and three
  train steps (tests/torch_field_parity.py: loss rtol 1e-4, gradients 1e-4
  of each leaf's max, field atol 3 lr), and the port's trainer through
  every phase (upsample, mask, shrink) with K3 launched 0 times on the CPU
  path's appearance (the CP lines are plain gathers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import one_torch_thread  # noqa: F401
from test_torch_tpu_trainer import CFG, SMALL
from torch_field_parity import jax_train_state, render_parity, step_parity
from torch_parity import field_leaves, flatten_field

from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.models.alpha_mask import \
    update_alpha_mask as jupdate_mask
from joint_tensorf_tpu.ops import blur as jblur
from joint_tensorf_tpu.ops.kernels import gaussian_kernel as jgauss
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import field_from_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.models import alpha_mask as am
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import densify
from joint_tensorf_tpu_torch.ops.kernels import gaussian_kernel
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

CP = dict(density_n_comp=(5, 5, 5), app_n_comp=(7, 7, 7), app_dim=6,
          hidden=8, decomposition="CP")
RES = (10, 12, 9)
AABB = [-1.5, -1.2, -1.0, 1.5, 1.4, 1.1]


def _cfgs(**kw):
    kw = {**CP, **kw}
    return jvm.VMConfig(**kw), vm.VMConfig(**kw)


def _pair(jcfg, pcfg, seed=0, scale=3.0):
    """A JAX CP state (density lines x ``scale``) and the port's copy."""
    st = jvm.init_vm(jax.random.PRNGKey(seed), jcfg, RES, AABB)
    st.density_lines = [l * scale for l in st.density_lines]
    return st, field_from_numpy(flatten_field(st), pcfg)


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-8,
                               err_msg=what)


def _coords(n=300, seed=1):
    return np.random.default_rng(seed).uniform(-1.05, 1.05,
                                               (3, n)).astype(np.float32)


def _mats(jax_side: bool):
    if jax_side:
        k = jgauss(jnp.float32(1.3), 8)
        return {L: jblur.blur_matrix(k, L) for L in set(RES)}
    k = gaussian_kernel(1.3, 8)
    return vm.make_blur_mats(k, RES)


def test_cp_init_matches_jax_shapes():
    jcfg, pcfg = _cfgs()
    st = jvm.init_vm(jax.random.PRNGKey(0), jcfg, RES, AABB,
                     init_scale=0.1, init_bias=0.5)
    field = vm.init_vm(pcfg, RES, AABB, torch.Generator().manual_seed(0),
                       init_scale=0.1, init_bias=0.5)
    assert len(field.density_planes) == len(field.app_planes) == 0
    assert st.density_planes == st.app_planes == []
    for group in ("density_lines", "app_lines"):
        got = [tuple(t.shape) for t in getattr(field, group)]
        assert got == [tuple(a.shape) for a in getattr(st, group)]
        assert got[0][0] == RES[2] and got[2][0] == RES[0]
        # scale * N(0, 1): signed, the bias not added
        allv = torch.cat([t.reshape(-1) for t in getattr(field, group)])
        assert (allv < 0).any() and abs(float(allv.mean())) < 0.05
    assert field.basis.shape == st.basis.shape == (7, 6)
    assert field.resolution() == st.resolution() == list(RES)
    assert dict(field.named_parameters()).keys() == field_leaves(
        flatten_field(st)).keys()


@pytest.mark.parametrize("variant", ["plain", "blurred", "component_wise"])
def test_cp_features_match_jax(variant):
    jcfg, pcfg = _cfgs(component_wise_feature2density=(
        variant == "component_wise"))
    st, field = _pair(jcfg, pcfg)
    blur = variant != "plain"
    c = _coords()
    w_app = np.random.default_rng(2).normal(size=6).astype(np.float32)

    def jf(st, c):
        cs = (c[0], c[1], c[2])
        m = _mats(True) if blur else None
        sig = jvm.compute_density_feature(st, jcfg, cs, blur_mats=m)
        app = jvm.compute_app_feature(st, jcfg, cs, blur_mats=m)
        return jnp.sum(sig * 0.3) + jnp.sum(app * w_app), (sig, app)

    (_, (j_sig, j_app)), (g_st, g_c) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(st, c)
    ct = torch.tensor(c, requires_grad=True)
    cs = (ct[0], ct[1], ct[2])
    m = _mats(False) if blur else None
    sig = vm.compute_density_feature(field, pcfg, cs, blur_mats=m)
    app = vm.compute_app_feature(field, pcfg, cs, blur_mats=m)
    np.testing.assert_allclose(sig.detach().numpy(), np.asarray(j_sig),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(app.detach().numpy(), np.asarray(j_app),
                               rtol=1e-5, atol=1e-7)
    params = dict(field.named_parameters())
    grads = torch.autograd.grad(
        torch.sum(sig * 0.3) + torch.sum(app * torch.as_tensor(w_app)),
        [ct] + list(params.values()), allow_unused=True)  # the head: none
    want = {"coords": g_c, **field_leaves(flatten_field(g_st))}
    for k, g in zip(["coords"] + list(params), grads):
        _close(np.zeros_like(want[k]) if g is None else g.numpy(), want[k],
               1e-4, f"gradient of {k}")


@pytest.mark.parametrize("variant", ["plain", "blurred", "component_wise"])
def test_cp_density_grid_matches_jax(variant):
    jcfg, pcfg = _cfgs(component_wise_feature2density=(
        variant == "component_wise"))
    st, field = _pair(jcfg, pcfg)
    blur = variant == "blurred"
    want = jvm.compute_density_grid(st, jcfg,
                                    blur_mats=_mats(True) if blur else None)
    got = vm.compute_density_grid(field, pcfg,
                                  blur_mats=_mats(False) if blur else None)
    assert tuple(got.shape) == RES
    _close(got.detach().numpy(), want, 1e-5, "dense grid")
    cs = tuple(torch.as_tensor(x) for x in _coords())
    dense = densify.sample_packed_grid(densify.pack_corners(got), cs)
    fact = vm.compute_density_feature(field, pcfg, cs,
                                      blur_mats=_mats(False) if blur
                                      else None)
    _close(dense.detach().numpy(), fact.detach().numpy(), 1e-5,
           "dense vs factored")


def test_cp_regularisers_match_jax():
    jcfg, pcfg = _cfgs()
    st, field = _pair(jcfg, pcfg)

    def jf(st):
        terms = (jvm.density_L1(st), jvm.tv_loss_density(st),
                 jvm.tv_loss_app(st), jvm.vector_comp_diffs(st))
        return terms[0] + 3.0 * terms[1] + 5.0 * terms[2] + terms[3], terms

    (_, jterms), g_st = jax.jit(jax.value_and_grad(jf, has_aux=True))(st)
    terms = (vm.density_L1(field), vm.tv_loss_density(field),
             vm.tv_loss_app(field), vm.vector_comp_diffs(field))
    for name, a, b in zip(("L1", "TV density", "TV app", "vector diffs"),
                          terms, jterms):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5,
                                   err_msg=name)
    # the CP TV is the lines' TV x 1e-3
    line_tv = sum(2.0 * torch.mean((l[1:] - l[:-1]) ** 2)
                  for l in field.density_lines) * 1e-3
    assert float(terms[1]) == pytest.approx(float(line_tv), rel=1e-6)
    params = dict(field.named_parameters())
    loss = terms[0] + 3.0 * terms[1] + 5.0 * terms[2] + terms[3]
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    want = field_leaves(flatten_field(g_st))
    for k, g in zip(params, grads):
        _close(np.zeros_like(want[k]) if g is None else g.numpy(), want[k],
               1e-5, f"gradient of {k}")


def test_vm_vector_comp_diffs_matches_jax():
    kw = dict(density_n_comp=(3, 4, 2), app_n_comp=(5, 5, 5), app_dim=6,
              hidden=8)
    jcfg, pcfg = jvm.VMConfig(**kw), vm.VMConfig(**kw)
    st = jvm.init_vm(jax.random.PRNGKey(4), jcfg, RES, AABB)
    field = field_from_numpy(flatten_field(st), pcfg)
    want, g_st = jax.jit(jax.value_and_grad(jvm.vector_comp_diffs))(st)
    got = vm.vector_comp_diffs(field)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    params = {k: p for k, p in field.named_parameters()
              if k.split(".")[0].endswith("lines")}
    grads = torch.autograd.grad(got, list(params.values()))
    wl = field_leaves(flatten_field(g_st))
    for k, g in zip(params, grads):
        _close(g.numpy(), wl[k], 1e-5, f"gradient of {k}")


def test_cp_upsample_and_shrink_match_jax():
    jcfg, pcfg = _cfgs()
    st, field = _pair(jcfg, pcfg)
    target = [14, 17, 12]
    j_up, p_up = jvm.upsample(st, target), vm.upsample(field, target)
    assert p_up.resolution() == j_up.resolution() == target
    new_box = np.array([[-1.0, -0.7, -0.6], [1.1, 0.9, 0.8]], np.float32)
    j_sh, p_sh = jvm.shrink(j_up, new_box), vm.shrink(p_up, new_box)
    p_sh_own = vm.shrink(field_from_numpy(flatten_field(j_up), pcfg),
                         new_box)
    for j, p, atol in ((j_up, p_up, 1e-6), (j_sh, p_sh_own, 0.0)):
        assert len(p.density_planes) == len(p.app_planes) == 0
        want, got = field_leaves(flatten_field(j)), {
            k: v.detach().numpy() for k, v in p.named_parameters()}
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=k)
        np.testing.assert_array_equal(p.aabb.numpy(), np.asarray(j.aabb))
    assert p_sh.resolution() == j_sh.resolution() != target


@pytest.mark.parametrize("component_wise", [False, True])
def test_cp_alpha_mask_matches_jax(component_wise):
    jcfg, pcfg = _cfgs(component_wise_feature2density=component_wise,
                       density_shift=-3.0 if component_wise else -10.0)
    st, field = _pair(jcfg, pcfg, scale=12.0)
    res, step, thres = [14, 11, 9], 0.04, 1e-3
    jm, jbox = jupdate_mask(st, jcfg, res, step, thres)
    pm, pbox = am.update_alpha_mask(field, pcfg, res, step, thres)
    np.testing.assert_array_equal(pm.grid.numpy(), np.asarray(jm.grid))
    assert 0 < float(pm.grid.mean()) < 1
    np.testing.assert_allclose(pbox, np.asarray(jbox), atol=1e-6)


def test_cp_render_and_three_steps_match_jax():
    jcfg, pcfg = _cfgs()
    kw = dict(densify_density=True, app_k=6)
    render_parity(jcfg, pcfg, kw, kw, ts=jax_train_state(jcfg))
    step_parity(jcfg, pcfg, n_steps=3)


def test_cp_trainer_runs_every_phase():
    """BAT_CP through the port's trainer on the CPU: two upsamples, the
    mask build and the shrink, the dense grid under the blur."""
    sc = synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")
    pt = Trainer(set_options(CFG, SMALL + [
        "--arch.tensorf.model=BAT_CP", "--train_schedule.upsample_iters=[2,4]",
        "--train_schedule.update_alphamask_iters=[6]", "--max_iter=9",
        "--arch.tensorf.density_components=[8,8,8]",
        "--arch.tensorf.color_components=[12,12,12]"]), sc, device="cpu")
    assert pt.vm_cfg.decomposition == "CP"
    res0 = pt.resolution
    seen = set()
    pt.run(log_every=1, on_step=lambda tr, m: m is not None and seen.add(
        tr.last_step_config.densify_density))
    assert pt.resolution != res0 and pt.alpha_mask is not None
    assert True in seen
    assert len(pt.state.field.density_planes) == 0
    assert pt.state.field.basis.shape == (12, 6)
