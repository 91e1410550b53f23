"""BarfTrainer's loop and step as the benchmark drives them
(train/barf_trainer.py; benchmark/program.py's trainer contract).

* ``run(..., on_step=...)`` calls ``on_step(trainer, metrics)`` after each
  step and ``on_step(trainer, None)`` after it, in Trainer.run's order,
  with ``rays_per_step`` set, and ``callback`` still at log points;
* the host's draw then ``_step`` gives bit for bit what one step of the
  loop before the split gave (written out here) at one seed;
* an iteration under torch.profiler shows each ``jt.`` span of BARF's
  path with its ``jt.`` parent, and leaves the losses and parameters
  bitwise equal with the profiler off;
* ``count_syncs`` reads no sync in a step between log points on the CPU
  path;
* optim.adam_update_ (BARF's Adam: each operation once over every leaf)
  gives adam_update's parameters and moments bit for bit, frozen leaves
  and gradients near eps included, on the CPU and on the card;
* on the card (``-m cuda``; this file imports no JAX, so it runs there as
  ``python -m pytest --noconftest -q tests/test_torch_barf_run.py``) the
  CUDA-graphed poses and rays (``BarfTrainer._rays``) give the eager
  step's losses and parameters bit for bit, and a step after the capture
  syncs nowhere inside its spans.

A tiny BARF at the published MLP widths: 4 views of 16 x 16, 64 rays, 16
samples, fine sampling off, as configs/barf_blender.yaml otherwise.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.train.barf_trainer import BarfTrainer, to_device
from joint_tensorf_tpu_torch.train.optim import (adam_init, adam_update,
                                                 adam_update_)
from joint_tensorf_tpu_torch.utils import setup_torch, tracing

setup_torch()

TINY = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
        "--data.n_views=4", "--nerf.sample_intvs=16", "--nerf.n_rays=64",
        "--max_iter=20", "--seed=3"]
# each range of one iteration -> its jt. parent
SPANS = {
    "jt.trainer.rays": None,
    "jt.step": None,
    "jt.step.rays": "jt.step",
    "jt.render": "jt.step",
    "jt.render.mlp": "jt.render",
    "jt.render.composite": "jt.render",
    "jt.step.backward": "jt.step",
    "jt.step.adam": "jt.step",
}


@pytest.fixture(scope="module")
def scene():
    opt = set_options("configs/barf_blender.yaml", TINY)
    return synthetic.load(opt, "train", device="cpu")


def _trainer(scene):
    return BarfTrainer(set_options("configs/barf_blender.yaml", TINY), scene,
                       device="cpu")


def _state(tr):
    return {k: v.detach().clone() for k, v in tr.params.items()}


def test_run_keeps_the_trainer_contract(scene):
    tr = _trainer(scene)
    calls, logged = [], []

    def on_step(t, metrics):
        calls.append((t.it, None if metrics is None else sorted(metrics),
                      t.rays_per_step))

    tr.run(max_iter=3, log_every=2, on_step=on_step, stats=True,
           callback=lambda t, m: logged.append(m["it"]))
    keys = ["loss", "mse", "psnr"]
    assert calls == [(0, keys, 64), (0, None, 64), (1, keys, 64),
                     (1, None, 64), (2, keys, 64), (2, None, 64)]
    assert logged == [0, 2] and tr.it == 3
    assert tr.device == torch.device("cpu")


def _old_iteration(tr):
    """One step as train_iteration took it before the draw and the step
    were split (train/barf_trainer.py before the benchmark's contract)."""
    view_sel, ray_idx = (to_device(a, tr.device) for a in tr._sample_rays())
    draws = tr.draw(len(view_sel) * len(ray_idx))
    names = list(tr.params)
    loss, metrics = tr.loss(view_sel, ray_idx, tr.progress, draws)
    grads = torch.autograd.grad(loss, [tr.params[k] for k in names],
                                allow_unused=True)
    grads = {k: (torch.zeros_like(tr.params[k]) if g is None else g)
             for k, g in zip(names, grads)}
    with torch.no_grad():
        new, tr.opt_state = adam_update(grads, tr.opt_state, tr.params,
                                        tr.lrs(), b2=0.999)
        for k in names:
            tr.params[k].copy_(new[k])
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return metrics


def test_draw_then_step_is_the_old_iteration_bit_for_bit(scene):
    old, new = _trainer(scene), _trainer(scene)
    for _ in range(3):
        a, b = _old_iteration(old), new.train_iteration()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        old.it += 1
        new.it += 1
    pa, pb = _state(old), _state(new)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(old.generator.get_state(), new.generator.get_state())
    assert np.array_equal(old.rng_np.permutation(8), new.rng_np.permutation(8))


def _jt_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith(tracing.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name


def test_profiler_shows_the_spans_and_leaves_the_step_bitwise(scene):
    runs = []
    for on in (False, True):
        tr = _trainer(scene)
        losses = []

        def on_step(t, m, losses=losses):
            if m is not None:
                losses.append(m["loss"].detach().clone())

        if on:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                tr.run(max_iter=1, log_every=100, on_step=on_step)
            got = [(e.name, _jt_parent(e)) for e in prof.events()
                   if e.name.startswith(tracing.PREFIX)]
            assert sorted(set(got)) == sorted(SPANS.items())
            # one MLP call and one quadrature a step without fine sampling
            assert sorted(n for n, _ in got) == sorted(SPANS)
        tr.run(max_iter=3, log_every=100, on_step=on_step)
        runs.append((losses, _state(tr)))
    (l0, p0), (l1, p1) = runs
    assert len(l0) == len(l1) == 3
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert tracing.STACK == []


def test_a_step_between_log_points_syncs_nothing(scene, monkeypatch):
    # the CPU path, as on a machine without a card (the card's is
    # test_graphed_rays_are_the_eager_step_bit_for_bit)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _trainer(scene)
    where, by_span = {}, {}

    def step():
        tr.train_iteration()
        tr.it += 1

    assert tracing.count_syncs(step, 2, where, by_span) == [0, 0]
    assert where == {} and by_span == {}
    assert tracing._on is False and tracing.STACK == []


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_multi_tensor_adam_is_adam_bit_for_bit(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    gen = torch.Generator().manual_seed(0)
    shapes = {"w": (63, 256), "b": (256,), "se3": (100, 6), "frozen": (3,)}
    params = {k: torch.randn(s, generator=gen).to(device)
              for k, s in shapes.items()}
    mine = {k: v.clone() for k, v in params.items()}
    state, state_ = adam_init(params), adam_init(mine)
    for it in range(4):
        # gradients from 1e-9 (about Adam's eps) to 1
        grads = {k: (torch.randn(s, generator=gen)
                     * 10.0 ** -float(torch.randint(0, 10, (), generator=gen))
                     ).to(device) for k, s in shapes.items()}
        lrs = {k: 5e-4 * 0.9 ** it for k in shapes}
        lrs["frozen"] = 0.0 if it < 2 else 1e-3
        new, state = adam_update(grads, state, params, lrs, b2=0.999)
        params = new
        state_ = adam_update_(grads, state_, mine, lrs, b2=0.999)
        assert state_.count == state.count == it + 1
        for k in shapes:
            assert torch.equal(params[k], mine[k]), (it, k)
            assert torch.equal(state.mu[k], state_.mu[k]), (it, k)
            assert torch.equal(state.nu[k], state_.nu[k]), (it, k)


@pytest.mark.cuda
def test_graphed_rays_are_the_eager_step_bit_for_bit(scene, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    runs = []
    for graphed in (True, False):
        if not graphed:
            monkeypatch.setattr(torch.cuda, "make_graphed_callables",
                                lambda fn, args: fn)
        tr = BarfTrainer(set_options("configs/barf_blender.yaml", TINY),
                         scene, device="cuda")
        losses = []

        def on_step(t, m, losses=losses):
            if m is not None:
                losses.append(m["loss"].clone())

        tr.run(max_iter=3, log_every=100, on_step=on_step)
        # the eager stand-in is the trainer's own bound method
        assert [getattr(f, "__self__", None) is tr
                for f in tr._graphed_rays.values()] == [not graphed]
        runs.append((losses, _state(tr)))
        if graphed:
            def step():
                tr.train_iteration()
                tr.it += 1
            by_span = {}
            tracing.count_syncs(step, 2, by_span=by_span)
            # none inside a span of the step (outside every span the sync
            # debug mode's own notice as it first turns on may count)
            assert not [k for k in by_span if k.startswith("jt.")], by_span
    (l0, p0), (l1, p1) = runs
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
