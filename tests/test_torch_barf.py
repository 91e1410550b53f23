"""PyTorch port vs JAX: BARF / MLP-NeRF (models/nerf_mlp.py,
train/barf_trainer.py, the BARF test-time optimiser, the simple
checkpoint and both CLIs' BARF branches).

* positional_encoding with BARF's c2f weights at progress 0, inside the
  window and past it (atol 1e-6);
* apply_nerf_mlp over the five density activations with density noise:
  rgb and density (rtol 1e-5), the gradients of a weighted sum to every
  leaf and to the points (within 1e-5 of each leaf's max);
* sample_depth (metric, inverse, stratified with JAX's uniforms and at
  the bins' centres), sample_depth_from_pdf (atol 1e-5) and composite
  with setbg on and off (outputs and gradients, rtol 1e-5);
* one BARF step and 5 steps with fine sampling, density noise and NDC,
  each from JAX's state with JAX's draws (the key split as
  train_iteration splits it): loss and metrics at rtol 1e-5, the Adam
  moments (the gradients) within 1e-4 of each leaf's max, every
  parameter within 1e-6 (a step moves a leaf by about lr);
* pose_error, render_views and validate (rtol 1e-5 / atol 1e-5);
* the test-time optimiser fed JAX's scan draws: the refined pose within
  1e-5, the loss at rtol 1e-4, at optim.lr_pose (the evaluate CLI passes
  it, not lr_pose_test);
* the simple checkpoint both ways (every leaf, it, the numpy generator,
  the pose noise) and a resume equal to the uninterrupted run bit for
  bit; a run with mid-run validation trains as one without (the port's
  render_views draws nothing, while JAX's advances its training key on
  every chunk);
* both CLIs on barf and nerf: the files train.py and evaluate.py write.
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import _jscene, one_torch_thread  # noqa: F401

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.models import nerf_mlp as jnm
from joint_tensorf_tpu.pose.test_optim import \
    make_barf_test_time_optimizer as jmake_barf_optimizer
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train.barf_trainer import BarfTrainer as JBarfTrainer
from joint_tensorf_tpu_torch import evaluate
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import (simple_state_from_numpy,
                                             simple_to_numpy)
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.models import nerf_mlp
from joint_tensorf_tpu_torch.pose import test_optim
from joint_tensorf_tpu_torch.train import __main__ as train_cli
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train.barf_trainer import BarfTrainer
from joint_tensorf_tpu_torch.utils import setup_torch, tree

setup_torch()

CFG = "configs/barf_blender.yaml"
SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--data.val_sub=2", "--nerf.sample_intvs=16",
         "--nerf.n_rays=64", "--camera.noise=0.05", "--max_iter=20",
         "--arch.layers_feat=[null,32,32,32]", "--arch.skip=[1]",
         "--arch.layers_rgb=[null,16,3]", "--arch.posenc.L_3D=4",
         "--arch.posenc.L_view=2"]
# fine sampling, density noise (nerf_llff_repr.yaml's) and NDC rays on the
# forward-facing scene; render_fine weighted so the fine MLP trains
FINE_NDC = ["--camera.ndc=true", "--data.scene=facing",
            "--nerf.depth.range=[0,1]", "--nerf.fine_sampling=true",
            "--+nerf.sample_intvs_fine=8", "--nerf.density_noise_reg=1",
            "--+loss_weight.render_fine=0", "--arch.density_activ=relu"]


def _np_tree(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np_tree(v) for v in x]
    return None if x is None else np.asarray(x)


def jax_state(jt) -> dict:
    """A JAX BarfTrainer's / PlanarTrainer's params and Adam state as the
    converter's nested numpy dict."""
    so = _np_tree(jt.opt_state)
    so["count"] = int(so["count"])
    return {"params": _np_tree(jt.params), "opt_state": so}


def carry(jt, pt):
    """The JAX trainer's params, moments, pose noise and generator into
    the port's."""
    pt.params, pt.opt_state = simple_state_from_numpy(jax_state(jt),
                                                      device="cpu")
    if getattr(jt, "pose_noise", None) is not None:
        from joint_tensorf_tpu_torch.geometry import poses as pose_ops

        pt.pose_noise = torch.as_tensor(np.array(jt.pose_noise))
        pt.pose_base = pose_ops.compose([pt.pose_noise, pt.gt_poses])
    pt.rng_np.bit_generator.state = jt.rng_np.bit_generator.state


def assert_state_close(jt, pt, atol_params, grad_rel=None):
    want = tree.flatten(jax_state(jt))
    got = tree.flatten(simple_to_numpy(pt.params, pt.opt_state))
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if k.startswith("params"):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol_params,
                                       err_msg=k)
        elif k.endswith("count"):
            assert g == w
        elif grad_rel is not None:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= grad_rel * scale, k


def jax_draws(jt) -> dict:
    """The draws JAX's next train_iteration makes from its key: the
    stratified uniforms from r1, the density noise from r2 (the same key
    for the coarse and fine shapes)."""
    _, k = jax.random.split(jt.key)
    r1, r2 = jax.random.split(k)
    n_rays = int(jt.opt.nerf.n_rays)
    n = (n_rays if jt.opt.nerf.ray_sampling_strategy ==
         "single_view_rand_rays" else jt.n_views * (n_rays // jt.n_views))
    S = int(jt.opt.nerf.sample_intvs)
    out = {"uniforms": jax.random.uniform(r1, (n, S))}
    dn = float(jt.opt.nerf.get("density_noise_reg") or 0.0)
    if dn:
        out["noise"] = jax.random.normal(r2, (n, S)) * dn
        if jt.fine_sampling:
            Sf = int(jt.opt.nerf.sample_intvs_fine)
            out["noise_fine"] = jax.random.normal(r2, (n, S + Sf)) * dn
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


def make_pair(extra=()):
    opt = set_options(CFG, SMALL + list(extra))
    sc = synthetic.load(opt, "train", device="cpu")
    val = synthetic.load(opt, "val", device="cpu")
    jt = JBarfTrainer(jset_options(CFG, SMALL + list(extra)), _jscene(sc),
                      _jscene(val))
    pt = BarfTrainer(opt, sc, val, device="cpu")
    carry(jt, pt)
    return jt, pt, sc, val


# ------------------------------------------------------------- the MLP
def _cfg(**kw):
    return dict(layers_feat=(32, 32, 32), layers_rgb=(16, 3), skip=(1,),
                L_3D=4, L_view=2, **kw)


@pytest.mark.parametrize("progress", [0.0, 0.2, 0.33, 1.0])
def test_positional_encoding_c2f(progress):
    x = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    want = jnm.positional_encoding(
        jnm.NerfMLPConfig(**_cfg(barf_c2f=(0.1, 0.5))), jnp.asarray(x), 6,
        jnp.float32(progress))
    got = nerf_mlp.positional_encoding(torch.as_tensor(x), 6, (0.1, 0.5),
                                       progress)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("activ", ["softplus", "relu", "abs", "sigmoid",
                                   "exp"])
def test_apply_nerf_mlp(activ):
    jcfg = jnm.NerfMLPConfig(**_cfg(density_activ=activ, barf_c2f=(0.1, 0.5)))
    cfg = nerf_mlp.NerfMLPConfig(**_cfg(density_activ=activ,
                                        barf_c2f=(0.1, 0.5)))
    jp = jnm.init_nerf_mlp(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (8, 6, 3)).astype(np.float32)
    ray = rng.normal(size=(8, 6, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    w_rgb = rng.normal(size=(8, 6, 3)).astype(np.float32)
    w_den = rng.normal(size=(8, 6)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (8, 6))) * 0.5

    def jloss(params, pts):
        rgb, den = jnm.apply_nerf_mlp(params, jcfg, pts, jnp.asarray(ray),
                                      progress=jnp.float32(0.3),
                                      density_noise=0.5, rng=key)
        return jnp.sum(rgb * w_rgb) + jnp.sum(den * w_den), (rgb, den)

    (_, (jrgb, jden)), (jg, jgp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(pts))
    flat = {k: torch.as_tensor(np.array(v)).requires_grad_(True)
            for k, v in tree.flatten(_np_tree(jp)).items()}
    tp = torch.as_tensor(pts).requires_grad_(True)
    rgb, den = nerf_mlp.apply_nerf_mlp(
        tree.unflatten(flat), cfg, tp, torch.as_tensor(ray), progress=0.3,
        noise=torch.as_tensor(noise))
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(den.detach().numpy(), np.asarray(jden),
                               rtol=1e-5, atol=1e-6)
    loss = torch.sum(rgb * torch.as_tensor(w_rgb)) + torch.sum(
        den * torch.as_tensor(w_den))
    names = list(flat)
    grads = torch.autograd.grad(loss, [flat[k] for k in names] + [tp])
    want = tree.flatten(_np_tree(jg))
    for k, g in zip(names + ["pts"], grads):
        w = np.asarray(jgp) if k == "pts" else want[k]
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("param", ["metric", "inverse"])
@pytest.mark.parametrize("stratified", [True, False])
def test_sample_depth(param, stratified):
    key = jax.random.PRNGKey(4)
    nf = jnp.asarray([2.0, 6.0], jnp.float32)
    want = jnm.sample_depth(key, 10, 16, nf, stratified, param)
    u = (torch.as_tensor(np.array(jax.random.uniform(key, (10, 16))))
         if stratified else None)
    got = nerf_mlp.sample_depth(10, 16, (2.0, 6.0), param, u)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_sample_depth_from_pdf():
    rng = np.random.default_rng(5)
    pdf = rng.uniform(0, 1, (64, 16)).astype(np.float32) ** 3
    pdf[3] = 0.0                                  # a ray with no weight
    pdf /= np.maximum(pdf.sum(-1, keepdims=True), 1e-6) * 1.05
    want = jnm.sample_depth_from_pdf(None, jnp.asarray(pdf),
                                     jnp.asarray([2.0, 6.0], jnp.float32), 24)
    got = nerf_mlp.sample_depth_from_pdf(torch.as_tensor(pdf), (2.0, 6.0), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("setbg", [True, False])
def test_composite(setbg):
    rng = np.random.default_rng(6)
    ray = rng.normal(size=(12, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (12, 10, 3)).astype(np.float32)
    den = rng.uniform(0, 3, (12, 10)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (12, 10)), -1).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)

    def jf(rgb, den):
        c, d, o, p = jnm.composite(None, jnp.asarray(ray), rgb, den,
                                   jnp.asarray(z), setbg, 1.0)
        return (w[0] * jnp.sum(c) + w[1] * jnp.sum(d) + w[2] * jnp.sum(o)
                + w[3] * jnp.sum(p)), (c, d, o, p)

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rgb), jnp.asarray(den))
    trgb = torch.as_tensor(rgb).requires_grad_(True)
    tden = torch.as_tensor(den).requires_grad_(True)
    out = nerf_mlp.composite(torch.as_tensor(ray), trgb, tden,
                             torch.as_tensor(z), setbg, 1.0)
    for g, wnt in zip(out, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wnt),
                                   rtol=1e-5, atol=1e-6)
    loss = sum(float(wi) * o.sum() for wi, o in zip(w, out))
    for g, wnt in zip(torch.autograd.grad(loss, [trgb, tden]), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------ the trainer
def _steps(jt, pt, n):
    for _ in range(n):
        draws = jax_draws(jt)
        jm = jt.train_iteration()
        pm = pt.train_iteration(draws)
        jt.it += 1
        pt.it += 1
        assert set(jm) == set(pm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert_state_close(jt, pt, atol_params=1e-6, grad_rel=1e-4)
        assert pt.rng_np.bit_generator.state == jt.rng_np.bit_generator.state


def test_barf_step_matches_jax():
    jt, pt, _, _ = make_pair()
    _steps(jt, pt, 1)
    assert float(np.abs(np.asarray(jt.params.se3_refine)).max()) > 0


def test_barf_fine_ndc_steps_match_jax():
    jt, pt, _, _ = make_pair(FINE_NDC + ["--nerf.ray_sampling_strategy="
                                         "single_view_rand_rays"])
    assert pt.fine_sampling and pt.ndc and pt.density_noise == 1.0
    _steps(jt, pt, 5)


@pytest.fixture(scope="module")
def stepped():
    jt, pt, sc, val = make_pair()
    jt.it = pt.it = 7            # inside the c2f window
    _steps(jt, pt, 2)
    return jt, pt, sc, val


def test_pose_error_render_views_validate(stepped):
    jt, pt, sc, val = stepped
    je, pe = jt.pose_error(), pt.pose_error()
    for k in ("rot_deg", "trans"):
        np.testing.assert_allclose(pe[k], je[k], rtol=1e-4, atol=1e-6)
    jv = jt.validate(_jscene(val))
    pv = pt.validate(val)
    np.testing.assert_allclose(pv["rgb"].numpy(), np.asarray(jv["rgb"]),
                               atol=1e-5)
    np.testing.assert_allclose(pv["depth"].numpy(), np.asarray(jv["depth"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pv["psnr"], jv["psnr"], rtol=1e-5)


def test_render_views_fine_ndc_matches_jax():
    jt, pt, sc, _ = make_pair(FINE_NDC)
    jrgb, jdep, jop = jt.render_views(jnp.asarray(sc.poses[:2]),
                                      jnp.asarray(sc.intr[:2]),
                                      jnp.asarray(sc.intr_inv[:2]))
    rgb, dep, op = pt.render_views(sc.poses[:2], sc.intr[:2],
                                   sc.intr_inv[:2])
    for g, w in ((rgb, jrgb), (dep, jdep), (op, jop)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("extra", [[], FINE_NDC])
def test_test_time_optimizer_matches_jax(stepped, extra):
    if extra:
        jt, pt, sc, _ = make_pair(extra)
    else:
        jt, pt, sc, _ = stepped
    opt = pt.opt
    n_rays, iters, lr = 32, 4, float(opt.optim.lr_pose)
    H, W = sc.H, sc.W
    joptimize = jmake_barf_optimizer(jt.mlp_cfg, jt.opt, H, W, n_rays, iters,
                                     lr, ndc=pt.ndc)
    rng = jax.random.PRNGKey(11)
    pose = np.asarray(sc.poses[1]) + np.float32(0.01)
    image = sc.images[1].reshape(3, -1).T
    jpose, jloss = joptimize(jt.params, jnp.asarray(pose), jnp.asarray(image),
                             jnp.asarray(sc.intr[1]),
                             jnp.asarray(sc.intr_inv[1]), jt.near_far, rng)
    keys = jax.random.split(rng, iters)

    def draws(it):
        r0, r1, _ = jax.random.split(keys[it], 3)
        idx = np.array(jax.random.permutation(r0, H * W)[:n_rays])
        u = np.asarray(jax.random.uniform(r1, (n_rays, pt.n_samples)))
        return torch.as_tensor(idx, dtype=torch.int64), torch.as_tensor(u.copy())

    optimize = test_optim.make_barf_test_time_optimizer(pt, H, W, n_rays,
                                                        iters, lr)
    ppose, ploss = optimize(torch.as_tensor(pose), torch.as_tensor(image),
                            torch.as_tensor(sc.intr[1]),
                            torch.as_tensor(sc.intr_inv[1]), draws=draws)
    np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), atol=1e-5)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-4)
    assert float(np.abs(ppose.numpy() - pose).max()) > 1e-5


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("extra", [[], FINE_NDC])
def test_simple_checkpoint_both_ways(tmp_path, extra):
    jt, pt, sc, val = make_pair(extra)
    _steps(jt, pt, 1)
    # JAX's file into a fresh port trainer
    jpath = str(tmp_path / "jax.ckpt.npz")
    jckpt.save_simple_checkpoint(jpath, jt)
    fresh = BarfTrainer(set_options(CFG, SMALL + list(extra)), sc, val,
                        device="cpu")
    ckpt.restore_simple_checkpoint(jpath, fresh)
    assert fresh.it == jt.it == 1
    assert fresh.rng_np.bit_generator.state == jt.rng_np.bit_generator.state
    assert_state_close(jt, fresh, atol_params=0, grad_rel=0)
    np.testing.assert_array_equal(fresh.pose_noise.numpy(),
                                  np.asarray(jt.pose_noise))
    # the port's file into a fresh JAX trainer
    ppath = str(tmp_path / "port.ckpt.npz")
    _steps(jt, pt, 1)
    ckpt.save_simple_checkpoint(ppath, pt)
    jfresh = JBarfTrainer(jset_options(CFG, SMALL + list(extra)),
                          _jscene(sc), _jscene(val))
    jckpt.restore_simple_checkpoint(ppath, jfresh)
    assert jfresh.it == pt.it == 2
    assert jfresh.rng_np.bit_generator.state == pt.rng_np.bit_generator.state
    assert_state_close(jfresh, pt, atol_params=0, grad_rel=0)
    np.testing.assert_array_equal(np.asarray(jfresh.pose_noise),
                                  pt.pose_noise.numpy())


def _params_np(pt):
    return {k: v.detach().numpy().copy() for k, v in pt.params.items()}


def test_resume_and_validation_do_not_move_training(tmp_path):
    """Six steps straight; three, a save, a fresh trainer's restore and
    three more; and six with a validation after each: the same params bit
    for bit (the torch generator's state is in the file, and render_views
    draws nothing)."""
    opt = set_options(CFG, SMALL + FINE_NDC)
    sc = synthetic.load(opt, "train", device="cpu")
    a = BarfTrainer(opt, sc, device="cpu")
    a.run(max_iter=6, log_every=100)
    b = BarfTrainer(opt, sc, device="cpu")
    b.run(max_iter=3, log_every=100)
    path = str(tmp_path / "model.ckpt.npz")
    ckpt.save_simple_checkpoint(path, b)
    c = BarfTrainer(opt, sc, device="cpu")
    ckpt.restore_simple_checkpoint(path, c)
    c.run(max_iter=6, log_every=100)
    v = BarfTrainer(opt, sc, device="cpu")
    state = v.generator.get_state()
    v.validate(sc)
    assert torch.equal(v.generator.get_state(), state)
    v.run(max_iter=6, log_every=1, callback=lambda t, m: t.validate(sc))
    pa = _params_np(a)
    for other in (c, v):
        po = _params_np(other)
        for k in pa:
            np.testing.assert_array_equal(po[k], pa[k], err_msg=k)
    # JAX's render_views splits the training key once per chunk
    jt = JBarfTrainer(jset_options(CFG, SMALL), _jscene(sc))
    key = np.asarray(jt.key).copy()
    jt.render_views(jnp.asarray(sc.poses[:1]), jnp.asarray(sc.intr[:1]),
                    jnp.asarray(sc.intr_inv[:1]))
    assert not np.array_equal(np.asarray(jt.key), key)


# ------------------------------------------------------------ the CLIs
TINY = ["--device=cpu", "--data.dataset=synthetic",
        "--data.image_size=[8,8]", "--data.n_views=4", "--data.val_sub=2",
        "--data.test_sub=2", "--nerf.sample_intvs=8", "--nerf.n_rays=32",
        "--arch.layers_feat=[null,16,16]", "--arch.skip=[]",
        "--arch.layers_rgb=[null,8,3]", "--arch.posenc.L_3D=2",
        "--arch.posenc.L_view=1", "--max_iter=8", "--freq.scalar=2",
        "--freq.val=4", "--freq.ckpt=4", "--+tb_logging=false"]


@pytest.mark.parametrize("yaml,name", [
    ("configs/barf_blender.yaml", "barf"),
    ("configs/nerf_blender_repr.yaml", "nerf")])
def test_clis_write_their_outputs(tmp_path, monkeypatch, yaml, name):
    root = str(tmp_path)
    args = [f"--yaml={yaml}", f"--output_root={root}", f"--name={name}"]
    train_cli.main(args + TINY)
    out = os.path.join(root, "default", name)
    for f in ("options.json", "log.jsonl", "model_it4.ckpt.npz",
              "model.ckpt.npz", "quant.json", "summary.json"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["it"] for r in rows] == [0, 2, 4, 6]
    pose_rows = [0] if name == "barf" else []
    assert [r["it"] for r in rows if "rot_deg" in r] == pose_rows
    assert [r["it"] for r in rows if "val_psnr" in r] == [4]
    with open(os.path.join(out, "quant.json")) as f:
        quant = json.load(f)
    assert quant["iters"] == 8 and math.isfinite(quant["val_psnr"])
    assert ("rot_deg" in quant) == (name == "barf")
    # --resume continues from the stored iteration
    train_cli.main(args + TINY + ["--resume=true", "--max_iter=10"])
    with open(os.path.join(out, "quant.json")) as f:
        assert json.load(f)["iters"] == 10

    seen = {}
    make = test_optim.make_barf_test_time_optimizer

    def spy(trainer, H, W, n_rays, test_iter, lr, **kw):
        seen["lr"] = lr
        return make(trainer, H, W, n_rays, test_iter, lr, **kw)

    monkeypatch.setattr(test_optim, "make_barf_test_time_optimizer", spy)
    results = evaluate.main(args + TINY + [
        "--max_iter=10", "--generate_video=false",
        "--generate_pose_video=false"]
        + (["--optim.test_iter=2"] if name == "barf" else []))
    if name == "barf":
        assert seen["lr"] == 1e-3                # optim.lr_pose
        with open(os.path.join(out, "quant_pose.txt")) as f:
            assert len(f.readlines()) == 4
        assert math.isfinite(results["rot_deg"])
    else:
        assert not seen and not os.path.exists(
            os.path.join(out, "quant_pose.txt"))
    with open(os.path.join(out, "quant.txt")) as f:
        assert [json.loads(line)["view"] for line in f] == [0, 1]
    with open(os.path.join(out, "quant_eval.json")) as f:
        quant = json.load(f)
    assert quant["iters"] == 10
    assert math.isfinite(quant["psnr"]) and math.isfinite(quant["ssim"])
    assert "clip_stats" not in quant
