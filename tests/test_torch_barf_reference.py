"""The port's BarfTrainer against the benchmark's plain reference
(benchmark/reference/barf.py, which imports nothing of the port): 3 steps
at the tiny cut of the benchmark's barf_blender configuration
(benchmark/tests/tiny_cuts/barf_blender.json: every MLP width, L and the
skip as published) on the CPU, through the benchmark's own model module
(benchmark/models/barf.py: weights and pose noise from the seed, the
trainer at the first iteration) and its comparison (program.first_steps),
at progress 0.3 (the c2f bands half open) and 0.75 (all open).

Tolerances (relative to the reference's value), each from what differs
between two sound float32 programs:
* the first loss, 2e-6: the two sides compute the poses and rays with
  other operations in another order (the pose noise's exponential map,
  the pixel back-projection), a few float32 ulps apart; the encoding's
  top band multiplies a point by 2^9 pi, so an ulp of a point becomes
  about 1e-4 of a radian in a sine.  Readings on 6 seeds: at most 2.7e-7
  with every band open, 0 at 0.3, where the top bands weigh 0;
* every loss, 1e-4: after the first update the two states differ by the
  above and by Adam's bias correction, which the port rounds to float32
  as JAX does (1 - 0.999 there is 1.3e-5 off, so every update is 6.4e-6
  apart); readings at most 1.5e-5;
* each MLP leaf's first gradient norm, 2e-3: the points' ulps above,
  through the first layers (readings at most 2.1e-4);
* the pose table's first gradient norm, 3e-2: a sum over every sample of
  terms that cancel, whose size is the high bands' (readings at most
  3.3e-3);
* the median leaf's change norm over the 3 steps, 5e-4: the 6.4e-6 of
  every update, and the elements whose gradient is near Adam's eps
  (readings at most 7.2e-5).
"""
import json
import os
import statistics

import pytest
import torch

from benchmark import program
from benchmark.models import barf as model
from benchmark.tests.tiny import BENCH, HERE, set_dotted

SEED = 2 ** 31 + 100
TOL = {"loss0": 2e-6, "losses": 1e-4, "grad_mlp": 2e-3, "grad_pose": 3e-2,
       "median_change": 5e-4}


def _options():
    with open(os.path.join(BENCH, "configs", "barf_blender.json")) as f:
        options = json.load(f)["options"]
    with open(os.path.join(HERE, "tiny_cuts", "barf_blender.json")) as f:
        for k, v in json.load(f).items():
            set_dotted(options, k, v)
    return options


def _gaps(prog, ref):
    return {k: abs(prog[k] - ref[k]) / abs(ref[k]) for k in ref}


@pytest.mark.parametrize("progress", [0.3, 0.75])
def test_port_agrees_with_the_plain_reference(progress):
    options = _options()
    start = round(progress * options["max_iter"])
    inputs = model.make_inputs(options, SEED, start, "cpu", 0.0)
    trainer = model.build(inputs, torch.device("cpu"))
    assert trainer.it == start and trainer.rays_per_step == 0
    prog = program.first_steps(model, trainer, 3, 200)
    ref = model.Reference(inputs, "cpu").run(3)
    assert ref["rays"] == trainer.rays_per_step == 64
    losses = [abs(p - r) / r for p, r in zip(prog["losses"], ref["losses"])]
    assert len(losses) == 3
    assert losses[0] <= TOL["loss0"], losses
    assert max(losses) <= TOL["losses"], losses
    grads = _gaps(prog["grad_norms"], ref["grad_norms"])
    assert set(grads) == {"se3_refine"} | {
        f"mlp.{p}.{i}.{w}" for p, n in (("feat", 8), ("rgb", 2))
        for i in range(n) for w in "wb"}
    assert grads.pop("se3_refine") <= TOL["grad_pose"]
    assert max(grads.values()) <= TOL["grad_mlp"], grads
    change = _gaps(prog["change_norms"], ref["change_norms"])
    assert statistics.median(change.values()) <= TOL["median_change"], change
    assert all(v > 0 for v in ref["change_norms"].values())
