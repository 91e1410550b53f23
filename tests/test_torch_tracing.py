"""The port's spans and host-sync counter (utils/tracing.py).

* One iteration of a tiny BAT and L2G-BAT Trainer under torch.profiler
  (CPU) shows every ``jt.`` range its path reaches, once each, with the
  ``jt.`` parent listed in SPANS (the mesh-only ``jt.step.reduce`` is not
  reached on one process);
* with no profiler ``span`` returns one shared no-op, and an iteration's
  loss and updated parameters are bitwise equal with the profiler on and
  off;
* ``count_syncs`` on the CPU returns zeros and never sets the sync debug
  mode; with a card faked it puts each sync warning down to its line and
  the innermost open span and leaves the mode at "default";
* on the card (``-m cuda``; this file imports no JAX, so it runs there as
  ``python -m pytest --noconftest -q tests/test_torch_tracing.py``) a
  masked tiny step's syncs name ``jt.trainer.upload`` at least twice.
"""
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.train.l2g_trainer import L2GTrainer
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch, tracing

setup_torch()

SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
         "--train_schedule.n_voxel_final=32768",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=20",
         "--train_schedule.upsample_iters=[2]",
         "--train_schedule.update_alphamask_iters=[3]",
         "--tpu.densify_min_samples_per_chip=1000"]
CONFIGS = {"bat": ("configs/bat_blender_VM.yaml", Trainer),
           "l2g": ("configs/l2g_bat_blender_VM.yaml", L2GTrainer)}
# each range of a first iteration at a log point -> its jt. parent
SPANS = {
    "jt.trainer.schedule": None,
    "jt.trainer.blur_cache": "jt.trainer.schedule",
    "jt.trainer.blur_mask": "jt.trainer.schedule",
    "jt.trainer.upload": None,
    "jt.step": None,
    "jt.step.rays": "jt.step",
    "jt.render": "jt.step",
    "jt.render.sample": "jt.render",
    "jt.render.density": "jt.render",
    # the density's route: the grid allowed, the factored sample taken
    # on a VM field in float32 rows (renderer.density_route)
    "jt.render.density.factored": "jt.render.density",
    "jt.render.appearance": "jt.render",
    "jt.step.loss": "jt.step",
    "jt.step.backward": "jt.step",
    "jt.step.adam": "jt.step",
    "jt.trainer.update_schedule": None,
    "jt.trainer.log_point": None,
}


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def _trainer(kind, scene, device="cpu", extra=()):
    yaml, cls = CONFIGS[kind]
    return cls(set_options(yaml, SMALL + list(extra)), scene, device=device)


def _jt_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith(tracing.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_one_iteration_shows_every_span_once_nested(kind, scene):
    tr = _trainer(kind, scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(max_iter=1, log_every=1)
    got = [(e.name, _jt_parent(e)) for e in prof.events()
           if e.name.startswith(tracing.PREFIX)]
    assert sorted(got) == sorted(SPANS.items())
    assert tracing.STACK == []


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not tracing._profiling()
    a, b = tracing.span("step"), tracing.span("render.sample")
    assert a is b
    with a:
        assert tracing.STACK == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("step") as s:
            assert s is not a and tracing.STACK == ["jt.step"]
    assert tracing.STACK == []


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_profiler_leaves_the_step_bitwise_unchanged(kind, scene):
    runs = []
    for on in (False, True):
        torch.manual_seed(0)
        tr = _trainer(kind, scene)
        tr.run(max_iter=2, log_every=100)
        losses = []

        def on_step(t, m, losses=losses):
            if m is not None:
                losses.append(m["loss"].detach().clone())

        if on:
            with profile(activities=[ProfilerActivity.CPU]):
                tr.run(max_iter=4, log_every=100, on_step=on_step)
        else:
            tr.run(max_iter=4, log_every=100, on_step=on_step)
        params = {k: v.detach().clone()
                  for k, v in tr.state.field.named_parameters()}
        runs.append((losses, params))
    (l0, p0), (l1, p1) = runs
    assert len(l0) == 2
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    assert p0.keys() == p1.keys()
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_count_syncs_on_the_cpu_counts_nothing(scene, monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    tr = _trainer("bat", scene)
    where, by_span = {}, {}

    def step():
        tr.train_iteration()
        tr._update_schedule()
        tr.it += 1

    assert tracing.count_syncs(step, 2, where, by_span) == [0, 0]
    assert where == {} and by_span == {} and modes == []
    assert tracing._on is False and tracing.STACK == []


def test_count_syncs_puts_each_sync_down_to_line_and_span(monkeypatch):
    """With a card faked: each warning of the sync debug mode is one sync,
    named by its line and the innermost open span; the mode is "warn"
    inside and "default" after, also when the call raises."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def step():
        warnings.warn("called a synchronizing CUDA operation")
        with tracing.span("trainer.upload"):
            assert tracing.STACK == ["jt.trainer.upload"]
            with tracing.span("step"):
                warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("some other warning")

    where, by_span = {}, {}
    assert tracing.count_syncs(step, 2, where, by_span) == [3, 3]
    assert modes == ["warn", "default"] * 2
    assert sum(where.values()) == 6 and len(where) == 3
    assert all(k.startswith("tests/test_torch_tracing.py:") for k in where)
    spans = {}
    for key, n in by_span.items():
        name = key.split(" ")[0]
        spans[name] = spans.get(name, 0) + n
    assert spans == {"-": 2, "jt.step": 2, "jt.trainer.upload": 2}
    assert tracing._on is False and tracing.STACK == []

    def fails():
        with tracing.span("step"):
            raise RuntimeError("boom")

    modes.clear()
    with pytest.raises(RuntimeError, match="boom"):
        tracing.count_syncs(fails, 1)
    assert modes == ["warn", "default"]
    assert tracing._on is False and tracing.STACK == []


@pytest.mark.cuda
def test_masked_step_syncs_name_the_upload(scene):
    """A tiny BAT step on the card past its mask update (masked and
    compacted): the two pageable uploads of train_iteration sync the host,
    under jt.trainer.upload."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode is CUDA's")
    card = synthetic.make_scene(n_views=4, H=16, W=16, device="cuda")
    tr = _trainer("bat", card, device="cuda", extra=[
        "--train_schedule.n_voxel_init=64000",
        "--train_schedule.n_voxel_final=262144"])
    tr.run(max_iter=8, log_every=100)
    assert tr.alpha_mask is not None and tr.last_step_config.blur is None
    where, by_span = {}, {}

    def step():
        tr.train_iteration()
        tr._update_schedule()
        tr.it += 1

    counts = tracing.count_syncs(step, 2, where, by_span)
    upload = sum(n for k, n in by_span.items()
                 if k.startswith("jt.trainer.upload "))
    assert upload >= 4, by_span
    assert sum(counts) == sum(by_span.values()) == sum(where.values())
