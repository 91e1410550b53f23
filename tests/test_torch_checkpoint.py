"""Checkpoints across the two packages (train/checkpoint.py, the JAX .npz
layout).

* A checkpoint written by JAX's save_checkpoint (a box of density, its
  mask, a random pose refinement, the noise matrices) restores into a fresh
  JAX trainer and a fresh port trainer alike: equal iteration, shapes,
  re-probed budgets (compact_k, app_k_dyn) and numpy generator state, and
  render_views of the validation views within 1e-5 of max|rgb|.
* A checkpoint the port writes from that state restores the same way into
  both, and holds JAX's own key (PRNGKey(seed)) and noise matrices.
* A port save / restore round trip keeps every state leaf, the mask bits
  and the torch generator's state, and the numpy generator's state equals
  the saved trainer's after the same two re-probes (restore draws them
  from it, as JAX's restore does).
* Port save -> port restore -> more steps equals the uninterrupted run
  (state leaves within 1e-6, equal draws).  The save falls before the
  first upsample and mask update, and the 2D blur schedule is constant:
  on restore JAX (and so the port) keeps the in-bbox budget of the fresh
  trainer, re-probes the mask budget from the training generator and
  rebuilds the 2D blur cache at the restored iteration's progress, each
  of which would part a later resume from the uninterrupted run (ROADMAP
  Queue 3).
* Asynchronous writes (async_write=True, one ordered writer thread): a
  queued write of that state restores into JAX's trainer as the
  synchronous one does (read only after wait_for_pending); two queued
  writes to one path leave the later one there and each snapshot its
  own; a write that fails re-raises from wait_for_pending, which then
  has nothing left to raise; and the payload is copied when the write is
  queued: optimiser steps taken while the writer is held back change
  nothing in the file.  The train CLI queues its per-iteration snapshots
  and drains the queue before its final synchronous write; the snapshots
  and the final file restore into both packages, leaf for leaf.  Threads
  queueing writes at once under a short switch interval lose none.
* Every shading head's tree (MLP_Fea4's four "layers", the three-layer
  heads' "layer1".."layer3" with the density head's hidden + 1 wide layer
  2, GaRF's gaussians, SH's and RGB's empty tree) and a CP state (no
  plane leaves), with random Adam moments and count: JAX's file restores
  into the port leaf for leaf, and the port's file of that state into a
  fresh JAX trainer, equal bit for bit.
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import (CFG, SMALL, _box_field, _jscene,  # noqa: F401
                             one_torch_thread)
from test_torch_tpu_trainer import SMALL as TPU_SMALL
from torch_parity import flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import to_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.models.shading import HEAD_NAMES
from joint_tensorf_tpu_torch.train import __main__ as train_cli
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch
from joint_tensorf_tpu_torch.utils.tree import flatten

setup_torch()

BUDGETS = ("compact_k", "app_k_dyn")


@pytest.fixture(scope="module")
def scenes():
    return (synthetic.make_scene(n_views=6, H=32, W=32, device="cpu"),
            synthetic.make_scene(n_views=2, H=32, W=32, pose_seed=1000,
                                 device="cpu"))


@pytest.fixture(scope="module")
def jax_ckpt(scenes, tmp_path_factory):
    sc, val = scenes
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(sc), _jscene(val))
    rng = np.random.default_rng(0)
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, field=_box_field(jt.state.params.field, rng),
        se3_refine=jnp.asarray(rng.normal(size=(6, 6)) * 0.01,
                               jnp.float32)))
    jt._update_alphamask(12)
    jt.it = 13
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.ckpt.npz")
    jckpt.save_checkpoint(path, jt)
    return path


def _restore_both(path, scenes):
    sc, val = scenes
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(sc), _jscene(val))
    jckpt.restore_checkpoint(path, jt)
    pt = Trainer(set_options(CFG, SMALL), sc, val, device="cpu")
    ckpt.restore_checkpoint(path, pt)
    return jt, pt


def _check_pair(jt, pt, val):
    assert pt.it == jt.it == 13
    assert pt.resolution == jt.resolution
    assert pt.n_samples == jt.n_samples
    assert pt.alpha_mask is not None and jt.alpha_mask is not None
    np.testing.assert_array_equal(pt.alpha_mask.grid.numpy(),
                                  np.asarray(jt.alpha_mask.grid))
    for k in BUDGETS:
        assert getattr(pt, k) == getattr(jt, k), k
    assert pt.compact_k is not None
    assert pt.rng_np.bit_generator.state == jt.rng_np.bit_generator.state
    np.testing.assert_allclose(pt.pose_base.numpy(), np.asarray(jt.pose_base),
                               atol=1e-6)
    rgb_j = np.asarray(jt.render_views(jnp.asarray(val.poses),
                                       jnp.asarray(val.intr),
                                       jnp.asarray(val.intr_inv))[0])
    rgb_p = pt.render_views(torch.as_tensor(val.poses), val.intr,
                            torch.as_tensor(val.intr_inv))[0].numpy()
    np.testing.assert_allclose(rgb_p, rgb_j,
                               atol=1e-5 * float(np.abs(rgb_j).max()))


def test_jax_checkpoint_restores_into_port(jax_ckpt, scenes):
    jt, pt = _restore_both(jax_ckpt, scenes)
    _check_pair(jt, pt, scenes[1])


def test_port_checkpoint_restores_into_jax(jax_ckpt, scenes, tmp_path):
    _, pt = _restore_both(jax_ckpt, scenes)
    path = str(tmp_path / "port.ckpt.npz")
    ckpt.save_checkpoint(path, pt)
    data = np.load(path)
    np.testing.assert_array_equal(data["key"], np.asarray(
        jax.random.PRNGKey(int(pt.opt.get("seed", 0)))))
    assert data["key"].dtype == np.uint32
    np.testing.assert_array_equal(data["pose_noise"],
                                  np.load(jax_ckpt)["pose_noise"])
    jt, pt = _restore_both(path, scenes)
    _check_pair(jt, pt, scenes[1])


TINY = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
        "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
        "--train_schedule.n_voxel_final=32768",
        "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
        "--blur_2d_c2f_kernel_size=15", "--max_iter=14",
        "--blur_2d_c2f_schedule=[0.025,0.025]",
        "--train_schedule.upsample_iters=[4,6]",
        "--train_schedule.update_alphamask_iters=[7,10]"]


@pytest.fixture(scope="module")
def tiny_scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def _leaves(t):
    out = {k: v.detach().clone()
           for k, v in t.state.field.named_parameters()}
    out["aabb"] = t.state.field.aabb.clone()
    out["se3_refine"] = t.state.se3_refine.detach().clone()
    out["pose_grad_accum"] = t.state.pose_grad_accum.clone()
    for m in ("mu", "nu"):
        for k, v in getattr(t.state.scene_opt, m).items():
            out[f"scene_opt.{m}.{k}"] = v.clone()
        out[f"pose_opt.{m}"] = getattr(t.state.pose_opt, m)[
            "se3_refine"].clone()
    return out


def test_port_round_trip_keeps_everything(tiny_scene, tmp_path):
    a = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    a.run(max_iter=9, log_every=3)
    assert a.alpha_mask is not None
    path = str(tmp_path / "model.ckpt.npz")
    ckpt.save_checkpoint(path, a)
    b = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    ckpt.restore_checkpoint(path, b)
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert (a.state.scene_opt.count, a.state.pose_opt.count) == \
        (b.state.scene_opt.count, b.state.pose_opt.count)
    assert torch.equal(a.alpha_mask.grid, b.alpha_mask.grid)
    assert torch.equal(a.alpha_mask.aabb, b.alpha_mask.aabb)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.pose_base, b.pose_base)
    for k in ("it", "resolution", "n_samples", "alphamask_resolution",
              "n_voxels", "n_voxel_list", "lr_index", "lr_basis"):
        assert getattr(a, k) == getattr(b, k), k
    # restore re-probed both budgets from the restored numpy generator
    assert a._probe_compact_k() == b.compact_k
    assert a._probe_app_k() == b.app_k_dyn
    assert a.rng_np.bit_generator.state == b.rng_np.bit_generator.state


def test_port_resume_equals_uninterrupted_run(tiny_scene, tmp_path):
    full = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    full.run(log_every=2)
    first = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    first.run(max_iter=3, log_every=3)
    path = str(tmp_path / "model.ckpt.npz")
    ckpt.save_checkpoint(path, first)
    resumed = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    ckpt.restore_checkpoint(path, resumed)
    assert resumed.it == 3
    resumed.run(log_every=2)
    assert resumed.it == full.it == 14
    assert resumed.alpha_mask is not None
    lf, lr = _leaves(full), _leaves(resumed)
    for k in lf:
        np.testing.assert_allclose(lr[k].numpy(), lf[k].numpy(), atol=1e-6,
                                   err_msg=k)
    assert resumed.rng_np.bit_generator.state == \
        full.rng_np.bit_generator.state
    for k in BUDGETS + ("compact_k_bbox", "resolution", "n_samples"):
        assert getattr(resumed, k) == getattr(full, k), k


ZOO = {name: [f"--arch.shading.model={name}"] for name in HEAD_NAMES}
ZOO["RGB"].append("--arch.shading.app_dim=3")
ZOO["MLP_Fea_WeakView_Density"].append(
    "--+arch.shading.predict_density=true")
ZOO["BAT_CP"] = ["--arch.tensorf.model=BAT_CP"]


def _randomised(jt, seed):
    """JAX trainer state with random field values, moments and counts (the
    moments' .aabb zeros, as JAX keeps them)."""
    rng = np.random.default_rng(seed)

    def rand(a):
        return jnp.asarray(rng.normal(size=a.shape).astype(np.float32))

    st = jt.state
    field = dataclasses.replace(jax.tree.map(rand, st.params.field),
                                aabb=st.params.field.aabb)
    mu, nu = (dataclasses.replace(jax.tree.map(f, st.scene_opt.mu),
                                  aabb=jnp.zeros((2, 3)))
              for f in (rand, lambda a: jnp.abs(rand(a))))
    return dataclasses.replace(
        st, params=dataclasses.replace(st.params, field=field,
                                       se3_refine=rand(st.params.se3_refine)),
        scene_opt=dataclasses.replace(st.scene_opt, mu=mu, nu=nu,
                                      count=jnp.int32(3)),
        pose_opt=dataclasses.replace(st.pose_opt, mu=rand(st.pose_opt.mu),
                                     count=jnp.int32(5)))


def _same_leaves(got: dict, want: dict):
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_checkpoint_both_ways(tiny_scene, tmp_path, name):
    args = TPU_SMALL + ZOO[name]
    jt = JTrainer(jset_options(CFG, args), _jscene(tiny_scene))
    jt.state = _randomised(jt, 7)
    want = flatten_train_state(jt.state)
    if name == "BAT_CP":
        assert want["density_planes"] == want["app_planes"] == []
    jpath = str(tmp_path / "jax.ckpt.npz")
    jckpt.save_checkpoint(jpath, jt)
    pt = Trainer(set_options(CFG, args), tiny_scene, device="cpu")
    ckpt.restore_checkpoint(jpath, pt)
    got = to_numpy(pt.state)
    got.pop("aabb"), want.pop("aabb")
    for m in ("mu", "nu"):
        got["scene_opt"][m].pop("aabb", None)
        want["scene_opt"][m].pop("aabb")
    _same_leaves(got, want)
    ppath = str(tmp_path / "port.ckpt.npz")
    ckpt.save_checkpoint(ppath, pt)
    jt2 = JTrainer(jset_options(CFG, args), _jscene(tiny_scene))
    jckpt.restore_checkpoint(ppath, jt2)
    _same_leaves(flatten_train_state(jt2.state),
                 flatten_train_state(jt.state))


# ------------------------------------------------------- asynchronous writes
def test_queued_write_restores_into_jax(jax_ckpt, scenes, tmp_path):
    _, pt = _restore_both(jax_ckpt, scenes)
    path = str(tmp_path / "queued.ckpt.npz")
    ckpt.save_checkpoint(path, pt, async_write=True)
    ckpt.wait_for_pending()
    jt, pt = _restore_both(path, scenes)
    _check_pair(jt, pt, scenes[1])


def test_later_queued_write_wins(tiny_scene, tmp_path):
    a = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    a.run(max_iter=2, log_every=2)
    path = str(tmp_path / "model.ckpt.npz")
    first = _leaves(a)
    ckpt.save_checkpoint(path, a, async_write=True,
                         snapshot_path=str(tmp_path / "model_it2.ckpt.npz"))
    a.run(max_iter=4, log_every=2)
    ckpt.save_checkpoint(path, a, async_write=True,
                         snapshot_path=str(tmp_path / "model_it4.ckpt.npz"))
    ckpt.wait_for_pending()
    for name, it, want in (("model.ckpt.npz", 4, _leaves(a)),
                           ("model_it4.ckpt.npz", 4, _leaves(a)),
                           ("model_it2.ckpt.npz", 2, first)):
        b = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
        ckpt.restore_checkpoint(str(tmp_path / name), b)
        assert b.it == it, name
        got = _leaves(b)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    assert not list(tmp_path.glob("*.tmp.npz"))


def test_failed_write_raises_from_wait_for_pending(tiny_scene, tmp_path):
    a = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "missing" / "model.ckpt.npz"), a,
                         async_write=True)
    ckpt.save_checkpoint(str(tmp_path / "model.ckpt.npz"), a,
                         async_write=True)
    with pytest.raises(FileNotFoundError):
        ckpt.wait_for_pending()
    ckpt.wait_for_pending()                 # drained: nothing left
    assert (tmp_path / "model.ckpt.npz").exists()


def test_queued_payload_is_a_copy(tiny_scene, tmp_path, monkeypatch):
    """The CPU trainer's parameters share memory with tensor.numpy(): the
    queued payload must not, or the steps below would reach the file."""
    gate = threading.Event()
    write = ckpt._write_npz

    def held(*args):
        assert gate.wait(60), "the writer was never released"
        write(*args)

    monkeypatch.setattr(ckpt, "_write_npz", held)
    a = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    a.run(max_iter=3, log_every=3)
    saved, it = _leaves(a), a.it
    path = str(tmp_path / "model.ckpt.npz")
    ckpt.save_checkpoint(path, a, async_write=True)
    a.run(max_iter=5, log_every=5)          # Adam steps in place
    assert not torch.equal(_leaves(a)["density_planes.0"],
                           saved["density_planes.0"])
    gate.set()
    ckpt.wait_for_pending()
    b = Trainer(set_options(CFG, TINY), tiny_scene, device="cpu")
    ckpt.restore_checkpoint(path, b)
    assert b.it == it
    got = _leaves(b)
    for k in saved:
        assert torch.equal(got[k], saved[k]), k


CLI = ["--yaml=" + CFG, "--device=cpu"] + TINY[:8] + [
    "--max_iter=7", "--train_schedule.upsample_iters=[2]",
    "--train_schedule.update_alphamask_iters=[4]", "--freq.scalar=2",
    "--freq.val=0", "--freq.ckpt=2", "--+tb_logging=false", "--name=async"]


def test_train_cli_queues_its_snapshots(tiny_scene, tmp_path, monkeypatch):
    events = []
    write, drain = ckpt._write, ckpt.wait_for_pending

    def spy_write(path, payload, snapshot_path, async_write):
        events.append(("write", os.path.basename(snapshot_path or path),
                       async_write))
        write(path, payload, snapshot_path, async_write)

    def spy_drain():
        events.append(("drain",))
        drain()

    monkeypatch.setattr(ckpt, "_write", spy_write)
    monkeypatch.setattr(ckpt, "wait_for_pending", spy_drain)
    train_cli.main(CLI + [f"--output_root={tmp_path}"])
    assert events == [("write", f"model_it{i}.ckpt.npz", True)
                      for i in (2, 4, 6)] + [
        ("drain",), ("write", "model.ckpt.npz", False)]
    out = tmp_path / "default" / "async"
    args = [a for a in CLI if not a.startswith(("--yaml", "--device"))]
    for name, it in (("model_it2.ckpt.npz", 2), ("model_it6.ckpt.npz", 6),
                     ("model.ckpt.npz", 7)):
        pt = Trainer(set_options(CFG, args), tiny_scene, device="cpu")
        ckpt.restore_checkpoint(str(out / name), pt)
        jt = JTrainer(jset_options(CFG, args), _jscene(tiny_scene))
        jckpt.restore_checkpoint(str(out / name), jt)
        assert pt.it == jt.it == it, name
        got, want = to_numpy(pt.state), flatten_train_state(jt.state)
        got.pop("aabb"), want.pop("aabb")
        for m in ("mu", "nu"):
            got["scene_opt"][m].pop("aabb", None)
            want["scene_opt"][m].pop("aabb")
        _same_leaves(got, want)


def test_concurrent_queued_writes_all_land(tmp_path):
    """Threads queueing writes at once (more threads than cores, a short
    switch interval): every write lands, with its own payload, and one
    that fails is the exception wait_for_pending raises."""
    import sys

    n_threads, per_thread = 2 * (os.cpu_count() or 4), 5

    def queue(t):
        for i in range(per_thread):
            ckpt._write(str(tmp_path / f"w{t}_{i}.npz"),
                        {"a": np.full(64, t * 100 + i, np.int32)}, None,
                        True)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=queue, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        ckpt._write(str(tmp_path / "missing" / "x.npz"), {"a": np.zeros(1)},
                    None, True)
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    with pytest.raises(FileNotFoundError):
        ckpt.wait_for_pending()
    for t in range(n_threads):
        for i in range(per_thread):
            a = np.load(tmp_path / f"w{t}_{i}.npz")["a"]
            assert np.all(a == t * 100 + i)
