"""PyTorch port vs JAX: the variants no shipped config turns on.

* train_schedule.reset_on_last_upsample with each of density / appearance
  / basis: after the last upsample the carried groups and the shading head
  equal the upsampled field's bit for bit (and JAX's within 1e-6), the
  re-drawn groups have JAX's shapes and dtypes and are new, and the field
  optimiser is rebuilt as JAX's (count 0, float32 zero moments of the new
  shapes; the pose optimiser kept).
* tpu.factor_dtype bfloat16: the factors are bf16 after init, upsample
  and shrink and through the checkpoint both ways (bit for bit, JAX's
  file included), the basis and every Adam moment float32; three steps of
  both trainers (blurred, dense grid, app_k) from one state give losses
  within rtol 1e-4 and factors within 3 x lr_index + 2 bf16 ulps, all but
  2% of them within lr_index / 10 + 2 ulps.  A bf16 gradient keeps 8
  mantissa bits, so a float32 sum in another order can round it one ulp
  (0.4%) apart, which Adam's ratio over steps turns into a fraction of
  lr; a near-zero gradient still flips an update's sign, as in
  tests/test_torch_train.py.
* densify_impl lane with densify_dtype bfloat16: the dense-grid density
  and its gradients (grid and coordinates) equal JAX's
  sample_lane_grid(row_dtype="bfloat16") within rtol 1e-5 (both read the
  same bf16-rounded corners; float32 sums in another order), differ from
  the float32 reads, and a step through the trainer takes the bf16 reads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_eval import _jscene, one_torch_thread  # noqa: F401
from test_torch_tpu_trainer import CFG, SMALL
from torch_parity import as_f32, field_leaves, flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.ops import lane_grid as jlane
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import to_numpy, train_state_from_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import densify
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

GROUPS = {"density": ("density_planes", "density_lines"),
          "appearance": ("app_planes", "app_lines"), "basis": ("basis",)}
BF16 = ["--tpu.factor_dtype=bfloat16"]
LR_INDEX = 0.02


@pytest.fixture(scope="module")
def small_scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def _pair(scene, args):
    jt = JTrainer(jset_options(CFG, SMALL + args), _jscene(scene))
    pt = Trainer(set_options(CFG, SMALL + args), scene, device="cpu")
    pt.state, pt.pose_base = train_state_from_numpy(
        flatten_train_state(jt.state, jt.pose_base), pt.vm_cfg)
    return jt, pt


def _leaves(d):
    return {k: as_f32(v) for k, v in field_leaves(d).items()}


@pytest.mark.parametrize("group", ["density", "appearance", "basis"])
def test_reset_on_last_upsample(small_scene, group):
    args = [f"--train_schedule.reset_on_last_upsample.{group}=true"]
    jt, pt = _pair(small_scene, args)
    jt.it = pt.it = 2                   # the last (only) upsample
    before = to_numpy(pt.state)
    before_shading = {k: v.clone() for k, v in
                      pt.state.field.shading.named_parameters()}
    pose_opt = pt.state.pose_opt
    up = to_numpy(dataclasses.replace(pt.state, field=vm.upsample(
        pt.state.field, [64, 64, 64])))
    jt._update_schedule()
    pt._update_schedule()
    assert pt.resolution == jt.resolution == [64, 64, 64]
    got, want = to_numpy(pt.state), flatten_train_state(jt.state)
    g, w, u, b = (field_leaves(d) for d in (got, want, up, before))
    reset = {k for k in g if k.split(".")[0] in GROUPS[group]}
    assert reset
    for k in g:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        if k in reset:
            assert not np.array_equal(g[k], u[k]), k
        else:
            np.testing.assert_array_equal(g[k], u[k], err_msg=k)
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        if k.startswith("shading"):
            np.testing.assert_array_equal(g[k], b[k], err_msg=k)
    for k, v in pt.state.field.shading.named_parameters():
        assert torch.equal(v, before_shading[k]), k
    assert pt.state.scene_opt.count == 0 == int(jt.state.scene_opt.count)
    for m in ("mu", "nu"):
        gm, wm = field_leaves(got["scene_opt"][m]), field_leaves(
            want["scene_opt"][m])
        for k in gm:
            assert gm[k].dtype == np.float32 and not np.any(gm[k]), k
            assert gm[k].shape == wm[k].shape, k
    assert pt.state.pose_opt is pose_opt


def test_bf16_dtype_through_init_upsample_shrink_checkpoint(small_scene,
                                                            tmp_path):
    jt, pt = _pair(small_scene, BF16)
    jf = jt.state.params.field
    assert jf.density_planes[0].dtype == jnp.bfloat16

    def check(tr):
        f = tr.state.field
        for name, p in f.named_parameters():
            want = torch.bfloat16 if f.is_factor(name) else torch.float32
            assert p.dtype == want, name
        for m in (tr.state.scene_opt.mu, tr.state.scene_opt.nu):
            assert all(v.dtype == torch.float32 for v in m.values())

    check(pt)
    fresh = Trainer(set_options(CFG, SMALL + BF16), small_scene,
                    device="cpu")
    check(fresh)
    # the JAX state carried over bit for bit
    for k, w in field_leaves(flatten_train_state(jt.state)).items():
        np.testing.assert_array_equal(as_f32(field_leaves(
            to_numpy(pt.state))[k]), w.astype(np.float32), err_msg=k)
    pt.it = 2
    pt._update_schedule()                               # upsample
    check(pt)
    pt.state.field = vm.shrink(pt.state.field, [[-1.0] * 3, [1.0] * 3])
    check(pt)
    # the port's checkpoint, bit for bit
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(path, pt)
    assert np.load(path)["state/.params/.field/.app_planes/[1]"].dtype == "V2"
    back = Trainer(set_options(CFG, SMALL + BF16), small_scene, device="cpu")
    ckpt.restore_checkpoint(path, back)
    check(back)
    for (k, a), b in zip(pt.state.field.named_parameters(),
                         back.state.field.parameters()):
        assert torch.equal(a, b), k
    # JAX's checkpoint of bf16 factors (ml_dtypes, read back as '|V2')
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jt)
    back = Trainer(set_options(CFG, SMALL + BF16), small_scene, device="cpu")
    ckpt.restore_checkpoint(jpath, back)
    check(back)
    for k, w in field_leaves(flatten_train_state(jt.state)).items():
        got = field_leaves(to_numpy(back.state))[k]
        if w.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(got.view(np.uint16),
                                          w.view(np.uint16), err_msg=k)
        else:
            np.testing.assert_array_equal(got, w, err_msg=k)


def test_bf16_steps_match_jax(small_scene):
    jt, pt = _pair(small_scene, BF16)
    for it in range(3):
        _, step_key = jax.random.split(jt.key)
        jitter = np.asarray(jax.random.uniform(
            jax.random.split(step_key)[0], (64, 1)))
        jm = jt.train_iteration()
        pm = pt.train_iteration(jitter=torch.as_tensor(jitter))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"it {it}")
        jt.it += 1
        pt.it += 1
    got, want = _leaves(to_numpy(pt.state)), _leaves(
        flatten_train_state(jt.state))
    for k, w in want.items():
        if not k.split(".")[0].endswith(("planes", "lines")):
            continue
        ulp = 2.0 ** -7 * np.abs(w)            # 2 ulps of an 8-bit mantissa
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=3 * LR_INDEX + ulp.max(), err_msg=k)
        assert np.mean(np.abs(got[k] - w) > 0.1 * LR_INDEX + ulp) < 0.02, k


def _lane_inputs(rng, X=9, Y=8, Z=70, N=500):
    G = rng.normal(size=(X, Y, Z)).astype(np.float32)
    coords = rng.uniform(-1.05, 1.05, (3, N)).astype(np.float32)
    ct = rng.normal(size=N).astype(np.float32)
    return G, coords, ct


def test_lane_bf16_reads_match_jax():
    G, coords, ct = _lane_inputs(np.random.default_rng(0))

    def jax_fn(g, c):
        return jlane.sample_lane_grid(jlane.pack_lane_grid(g), tuple(c),
                                      G.shape[2], row_dtype="bfloat16")

    want, vjp = jax.vjp(jax_fn, jnp.asarray(G), jnp.asarray(coords))
    dG_want, dc_want = vjp(jnp.asarray(ct))

    def port(dtype):
        g = torch.tensor(G, requires_grad=True)
        c = torch.tensor(coords, requires_grad=True)
        out = densify.sample_packed_grid(densify.pack_corners(g), tuple(c),
                                         row_dtype=dtype)
        dg, dc = torch.autograd.grad(out, [g, c], torch.as_tensor(ct))
        return out.detach().numpy(), dg.numpy(), dc.numpy()

    got, dG, dc = port("bfloat16")
    for a, b in ((got, want), (dG, dG_want), (dc, dc_want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))
    f32 = port("float32")
    assert np.abs(f32[0] - got).max() > 1e-4      # the reads did round
    np.testing.assert_allclose(got, f32[0], rtol=2e-2, atol=2e-2)


def test_lane_bf16_step_reads_bf16(small_scene, monkeypatch):
    opt = set_options(CFG, SMALL + ["--tpu.densify_impl=lane",
                                    "--tpu.densify_dtype=bfloat16"])
    pt = Trainer(opt, small_scene, device="cpu")
    seen = []
    real = densify.sample_packed_grid
    monkeypatch.setattr(densify, "sample_packed_grid",
                        lambda *a, **k: seen.append(k) or real(*a, **k))
    m = pt.train_iteration()
    assert np.isfinite(float(m["loss"]))
    assert pt.last_step_config.densify_density
    assert pt.last_step_config.densify_dtype == "bfloat16"
    assert seen == [{"row_dtype": "bfloat16"}]
