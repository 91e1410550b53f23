"""A whole run of barf_blender.fullband on the CPU at its tiny cut with
BARF's step broken underneath (train/barf_trainer.py
``BarfTrainer._step``, the hook the benchmark's trainer wraps): for every
fault a one-chip training cell can have, ``correct`` comes out false
against the cell's limits: a step that returns its state unchanged, half
of each view's rays left out with the mean taken over the rest, a
rendered answer altered where it is produced."""
import time

import pytest
import torch

from benchmark import harness
from joint_tensorf_tpu_torch.train import barf_trainer

CELL = "barf_blender.fullband"
SEED = 2 ** 31 + 11


def _unchanged(real):
    def step(self, view_sel, ray_idx, draws):
        keep = {k: v.detach().clone() for k, v in self.params.items()}
        out = real(self, view_sel, ray_idx, draws)
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(keep[k])
        return out
    return step


def _half_batch(real):
    def step(self, view_sel, ray_idx, draws):
        half = ray_idx.shape[0] // 2
        n_views = view_sel.shape[0]
        draws = {k: v.reshape(n_views, -1, v.shape[-1])[:, :half]
                 .reshape(-1, v.shape[-1]) for k, v in draws.items()}
        return real(self, view_sel, ray_idx[:half], draws)
    return step


def _answer(real):
    def render(*a, **kw):
        rgb, rgb_f, depth, opacity = real(*a, **kw)
        return rgb + 1e-3, rgb_f, depth, opacity
    return render


def test_the_sound_step_is_correct(tiny_root):
    r = harness.run(tiny_root, CELL, SEED, 0.2, False, time.perf_counter(),
                    device="cpu")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
def test_a_broken_barf_step_is_not_correct(tiny_root, monkeypatch, fault):
    if fault == "answer":
        monkeypatch.setattr(barf_trainer, "render_mlp_rays",
                            _answer(barf_trainer.render_mlp_rays))
    else:
        wrap = _unchanged if fault == "unchanged" else _half_batch
        monkeypatch.setattr(barf_trainer.BarfTrainer, "_step",
                            wrap(barf_trainer.BarfTrainer._step))
    r = harness.run(tiny_root, CELL, SEED, 0.2, False, time.perf_counter(),
                    device="cpu")
    assert not r["correct"], r["checks"]
