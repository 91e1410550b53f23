"""A whole run of each cell on the CPU at a tiny size (the chip's look
skipped): the reference agrees with the port's CPU path on the first
steps, far inside the limits; and with the timed path broken underneath,
``correct`` comes out false for every fault a one-chip training cell can
have: a step that returns its state unchanged, half of the batch left out
with the mean taken over the rest, a rendered answer altered where it is
produced."""
import dataclasses
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests.tiny import ROOT
from joint_tensorf_tpu_torch.train import step as step_lib
from joint_tensorf_tpu_torch.train import trainer as trainer_lib

CELLS = spec.cells(ROOT)
SEED = 2 ** 31 + 11


def _run(root, cell, trace=False):
    return harness.run(root, cell, SEED, 0.2, trace, time.perf_counter(),
                       device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["loss_gap"]["value"] < 1e-5
    assert r["checks"]["median_change_gap"]["value"] < 1e-4
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"train_rays_per_s", "setup_s"} <= set(r["metrics"])


def _unchanged(real):
    def step(state, *a, **kw):
        keep = {k: v.detach().clone() for k, v in
                state.field.named_parameters()}
        se3 = state.se3_refine.detach().clone()
        out = real(state, *a, **kw)
        with torch.no_grad():
            for k, v in state.field.named_parameters():
                v.copy_(keep[k])
            state.se3_refine.copy_(se3)
        return out
    return step


def _half_batch(real):
    def step(state, cfg, vm_cfg, pose_base, intr_inv, images, edges,
             view_sel, ray_idx, s, **kw):
        half = ray_idx[:ray_idx.shape[0] // 2]
        return real(state, dataclasses.replace(cfg, grid_hw=None), vm_cfg,
                    pose_base, intr_inv, images, edges, view_sel, half, s,
                    **kw)
    return step


def _answer(real):
    def render(*a, **kw):
        rgb, depth, acc = real(*a, **kw)
        return rgb + 1e-3, depth, acc
    return render


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, fault):
    if fault == "answer":
        monkeypatch.setattr(step_lib, "render_rays",
                            _answer(step_lib.render_rays))
    else:
        wrap = _unchanged if fault == "unchanged" else _half_batch
        monkeypatch.setattr(trainer_lib, "train_step",
                            wrap(trainer_lib.train_step))
    r = _run(tiny_root, "bat_blender.masked")
    assert not r["correct"], r["checks"]
