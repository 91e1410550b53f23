"""PyTorch port vs JAX: the TensoRF baseline (``model: tensorf``).

configs/tensorf_synthetic_small.yaml cut to 16x16, 4 views, 40^3 -> 64^3
voxels (S 138 -> 221), 64 rays, small ranks:

* both trainers, each step from the JAX trainer's state (density in eight
  corner boxes, so the mask is selective), through the dense grid with the
  in-bbox budget, the upsample after iteration 2, and the mask build with
  its bbox shrink after iteration 4, then mask compaction: every step's
  loss at rtol 1e-4 (tests/test_torch_train.py's tolerance), the step's
  budget / dense-grid / app_k choices, the updated field (atol 3 x lr,
  nearly all entries to 1e-4, as in test_torch_train.py: Adam turns a
  near-zero gradient into a +-lr step), and after every schedule update
  the shapes, box, budgets and mask bits.  The pose table, its moments,
  count and accumulator stay zero on both sides and the port's pose
  gradient is zero; no pose noise is drawn, the blur and the pose lr are
  off, and the training poses are GT;
* stop_coord_grad: the coordinates are detached, the factor gradients are
  the same bit for bit, the plane and line gradients are still scattered
  (a plane and a line row scatter a fused sample: 6 calls fused; with
  app_k 6 for the appearance, and the density's summed sample (K6 on the
  card) its plain version's 6 index_add_ scatters), and the rays get no
  gradient;
* validate without alignment equals JAX's PSNR (1e-4);
* a checkpoint written by either package restores into both (leaves
  bit for bit, mask bits, renders within 5e-5 of max|rgb|);
* the train CLI logs no pose rows and quant.json holds no pose errors;
  the evaluate CLI writes no quant_pose.txt and renders at GT poses;
* check_ported accepts model: l2g_bat (tests/test_torch_l2g.py) and
  still refuses, by name, a model the port does not run.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import _jscene, one_torch_thread  # noqa: F401
from test_torch_tpu_trainer import (_blob_field, _jax_step_choice,
                                    _port_step_choice)
from torch_parity import field_leaves, flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch import evaluate
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import to_numpy, train_state_from_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.geometry.rays import get_center_and_ray
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import densify, sampling
from joint_tensorf_tpu_torch.render.renderer import RenderConfig, render_rays
from joint_tensorf_tpu_torch.train import __main__ as train_cli
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train.trainer import Trainer, check_ported
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

CFG = "configs/tensorf_synthetic_small.yaml"
SMALL = ["--data.image_size=[16,16]", "--data.n_views=4", "--data.val_sub=2",
         "--train_schedule.n_voxel_init=64000",
         "--train_schedule.n_voxel_final=262144", "--nerf.n_rays=64",
         "--max_iter=20", "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--train_schedule.upsample_iters=[2]",
         "--train_schedule.update_alphamask_iters=[4]",
         # the dense grid at this size's 64 rays x S samples per step
         "--tpu.densify_min_samples_per_chip=1000"]
BUDGETS = ("compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")
LR_INDEX, LR_BASIS = 0.02, 1e-3


@pytest.fixture(scope="module")
def scenes():
    return (synthetic.make_scene(n_views=4, H=16, W=16, device="cpu"),
            synthetic.make_scene(n_views=2, H=16, W=16, pose_seed=1000,
                                 device="cpu"))


def _pair(scenes):
    sc, val = scenes
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(sc), _jscene(val))
    pt = Trainer(set_options(CFG, SMALL), sc, val, device="cpu")
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params,
        field=_blob_field(jt.state.params.field, np.random.default_rng(0))))
    pt.state, _ = train_state_from_numpy(flatten_train_state(jt.state),
                                         pt.vm_cfg)
    return jt, pt


def _assert_fields_close(got: dict, want: dict, what):
    for k, w in field_leaves(want).items():
        g = field_leaves(got)[k]
        lr = LR_INDEX if k.split(".")[0].endswith(("planes", "lines")) \
            else LR_BASIS
        np.testing.assert_allclose(g, w, atol=3 * lr, err_msg=f"{what} {k}")
        assert np.mean(np.abs(g - w) > 1e-4) < 0.01, (what, k)


def test_tensorf_trainer_matches_jax(scenes):
    jt, pt = _pair(scenes)
    assert not pt.is_bat and not jt.is_bat
    assert pt.pose_noise is None and jt.pose_noise is None
    np.testing.assert_array_equal(pt.pose_base.numpy(), scenes[0].poses)
    assert pt._lr_pose() == jt._lr_pose() == 0.0
    assert pt.resolution == jt.resolution == [40, 40, 40]
    assert pt.compact_k_bbox == jt.compact_k_bbox
    seen = set()
    for it in range(8):
        pt.state, _ = train_state_from_numpy(flatten_train_state(jt.state),
                                             pt.vm_cfg)
        _, step_key = jax.random.split(jt.key)
        jitter = np.asarray(jax.random.uniform(jax.random.split(step_key)[0],
                                               (64, 1)))
        jm = jt.train_iteration()
        pm = pt.train_iteration(jitter=torch.as_tensor(jitter))
        assert pt.last_step_config.blur is None
        assert not pt.last_step_config.pose_opt
        assert _port_step_choice(pt) == _jax_step_choice(jt), it
        seen.add(_port_step_choice(pt))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"it {it}")
        got, want = to_numpy(pt.state), flatten_train_state(jt.state)
        _assert_fields_close(got, want, f"it {it}")
        assert got["scene_opt"]["count"] == want["scene_opt"]["count"]
        for d in (got, want):
            assert not np.any(d["se3_refine"]) and d["pose_opt"]["count"] == 0
            assert not np.any(d["pose_opt"]["mu"])
            assert not np.any(d["pose_grad_accum"])
        jt._update_schedule()
        pt._update_schedule()
        assert pt.resolution == jt.resolution and \
            pt.n_samples == jt.n_samples, it
        np.testing.assert_allclose(pt.state.field.aabb.numpy(),
                                   np.asarray(jt.state.params.field.aabb),
                                   atol=1e-6)
        for k in BUDGETS:
            assert getattr(pt, k) == getattr(jt, k), (it, k)
        assert (pt.alpha_mask is None) == (jt.alpha_mask is None)
        if pt.alpha_mask is not None:
            np.testing.assert_array_equal(pt.alpha_mask.grid.numpy(),
                                          np.asarray(jt.alpha_mask.grid))
        jt.it += 1
        pt.it += 1
    # the upsample, the shrink, and both the dense grid and mask compaction
    assert pt.resolution != [40, 40, 40]
    assert not np.allclose(pt.state.field.aabb.numpy(),
                           [[-1.5] * 3, [1.5] * 3])
    assert any(s[1] for s in seen) and any(
        s[3] == "sharp" and s[0] is not None for s in seen), seen
    pose, gt = pt.get_all_training_poses()
    assert torch.equal(pose, gt)


def test_train_step_pose_table_gets_no_gradient(scenes):
    _, pt = _pair(scenes)
    before = pt.state.se3_refine.detach().clone()
    grads = {}

    import joint_tensorf_tpu_torch.train.trainer as trainer_mod
    real = trainer_mod.train_step

    def spy(*a, **k):
        out = real(*a, **k)
        grads.update(out[1])
        return out
    trainer_mod.train_step = spy
    try:
        pt.train_iteration()
    finally:
        trainer_mod.train_step = real
    assert torch.count_nonzero(grads["se3_refine"]) == 0
    assert torch.equal(pt.state.se3_refine, before)
    assert pt.state.pose_opt.count == 0
    assert any(torch.count_nonzero(grads[k]) > 0 for k in grads
               if k.startswith("density_planes"))


@pytest.mark.parametrize("app_k", [None, 8])
def test_stop_coord_grad_still_scatters_factors(monkeypatch, app_k):
    cfg = vm.VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                      app_dim=6, hidden=8)
    field = vm.init_vm(cfg, (20, 20, 20), [-1.5] * 3 + [1.5] * 3,
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in list(field.density_planes) + list(field.density_lines):
            p.mul_(8.0)
    scene = synthetic.make_scene(n_views=1, H=12, W=12, device="cpu")
    jitter = torch.rand((144, 1), generator=torch.Generator().manual_seed(1))
    calls, rows = [], []
    for mod in (sampling, densify):
        real = mod.scatter_add_rows
        monkeypatch.setattr(mod, "scatter_add_rows",
                            lambda *a, real=real: calls.append(1) or real(*a))
    real_rows = sampling._index_add_rows
    monkeypatch.setattr(sampling, "_index_add_rows",
                        lambda *a: rows.append(1) or real_rows(*a))

    def grads(stop):
        c, d = get_center_and_ray(12, 12, torch.as_tensor(scene.poses),
                                  torch.as_tensor(scene.intr_inv))
        c = c.reshape(-1, 3).detach().requires_grad_(True)
        rcfg = RenderConfig(n_samples=48, is_train=True, app_k=app_k,
                            stop_coord_grad=stop)
        rgb, _, _ = render_rays(field, cfg, rcfg, c, d.reshape(-1, 3),
                                (2.0, 6.0), ray_jitter=jitter)
        params = dict(field.named_parameters())
        g = torch.autograd.grad(torch.sum(rgb ** 2),
                                list(params.values()) + [c],
                                allow_unused=True)
        return dict(zip(params, g[:-1])), g[-1]

    g_free, c_free = grads(False)
    n_free, calls[:] = len(calls), []
    rows_free, rows[:] = len(rows), []
    g_stop, c_stop = grads(True)
    assert len(calls) == n_free == 6
    assert len(rows) == rows_free == (0 if app_k is None else 6)
    assert c_stop is None and torch.count_nonzero(c_free) > 0
    for k in g_free:
        assert torch.equal(g_stop[k], g_free[k]), k
    for k in ("density_planes.0", "density_lines.0", "app_planes.2",
              "app_lines.1"):
        assert torch.count_nonzero(g_stop[k]) > 0, k


def test_validate_without_alignment_matches_jax(scenes):
    jt, pt = _pair(scenes)
    val = scenes[1]
    # a pose table that alignment would use, were it on
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, se3_refine=jnp.full((4, 6), 0.05, jnp.float32)))
    pt.state, _ = train_state_from_numpy(flatten_train_state(jt.state),
                                         pt.vm_cfg)
    want = jt.validate(_jscene(val))["psnr"]
    got = pt.validate(val)["psnr"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, pt.validate(val, align=False)["psnr"],
                               rtol=0)


def _check_restored(jt, pt, val):
    assert pt.it == jt.it == 5
    assert pt.resolution == jt.resolution
    np.testing.assert_array_equal(pt.alpha_mask.grid.numpy(),
                                  np.asarray(jt.alpha_mask.grid))
    got, want = to_numpy(pt.state), flatten_train_state(jt.state)
    for k, w in field_leaves(want).items():
        np.testing.assert_array_equal(field_leaves(got)[k], w, err_msg=k)
    rgb_j = np.asarray(jt.render_views(jnp.asarray(val.poses),
                                       jnp.asarray(val.intr),
                                       jnp.asarray(val.intr_inv))[0])
    rgb_p = pt.render_views(torch.as_tensor(val.poses), val.intr,
                            torch.as_tensor(val.intr_inv))[0].numpy()
    # 5e-5: float32 sums in another order (JAX's lane layout sums 128
    # masked lanes per dense-grid read, the port 8 corners) behind steep
    # opacity edges of the eight density boxes
    np.testing.assert_allclose(rgb_p, rgb_j,
                               atol=5e-5 * float(np.abs(rgb_j).max()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_round_trip_both_ways(scenes, tmp_path, writer):
    sc, val = scenes
    jt, pt = _pair(scenes)
    jt._update_alphamask(4)
    jt.it = 5
    path = str(tmp_path / "tensorf.ckpt.npz")
    if writer == "jax":
        jckpt.save_checkpoint(path, jt)
    else:
        from test_torch_eval import carry_to_port
        carry_to_port(jt, pt)
        pt.it = 5
        ckpt.save_checkpoint(path, pt)
        assert "pose_noise" not in np.load(path).files
    jt2 = JTrainer(jset_options(CFG, SMALL), _jscene(sc), _jscene(val))
    jckpt.restore_checkpoint(path, jt2)
    pt2 = Trainer(set_options(CFG, SMALL), sc, val, device="cpu")
    ckpt.restore_checkpoint(path, pt2)
    _check_restored(jt2, pt2, val)


def test_cli_writes_no_pose_files(tmp_path):
    args = [f"--yaml={CFG}", "--device=cpu", f"--output_root={tmp_path}",
            "--name=tensorf", "--max_iter=6", "--freq.scalar=1",
            "--freq.val=4", "--freq.ckpt=0", "--+tb_logging=false"] + [
        a for a in SMALL if not a.startswith("--max_iter")]
    train_cli.main(args)
    out = os.path.join(tmp_path, "default", "tensorf")
    with open(os.path.join(out, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["it"] for r in rows] == list(range(6))
    assert not any("rot_deg" in r for r in rows)
    assert [r["it"] for r in rows if "val_psnr" in r] == [4]
    with open(os.path.join(out, "quant.json")) as f:
        quant = json.load(f)
    assert np.isfinite(quant["val_psnr"]) and "rot_deg" not in quant
    # no pose video to refuse without pose optimisation
    results = evaluate.main(args + ["--generate_video=false"])
    assert not os.path.exists(os.path.join(out, "quant_pose.txt"))
    assert "rot_deg" not in results and np.isfinite(results["psnr"])
    with open(os.path.join(out, "quant.txt")) as f:
        assert len(f.readlines()) == 2


def test_check_ported_refuses_l2g_bat():
    """l2g_bat runs (tests/test_torch_l2g.py); a model
    the port does not run is still refused by name."""
    check_ported(set_options(CFG, SMALL))
    check_ported(set_options(CFG, SMALL + ["--model=l2g_bat"]))
    with pytest.raises(NotImplementedError, match="model='barf'"):
        check_ported(set_options(CFG, SMALL + ["--model=barf"]))
