"""The system under test, driven as users run it: the port's Trainer
(joint_tensorf_tpu_torch/train/trainer.py) and its ``run`` loop.

``SpanTrainer`` adds the benchmark's host span around ``Trainer._step``
(the hook L2GTrainer overrides).  ``build`` makes the Trainer on the
benchmark's inputs and brings it to the cell's first iteration through the
Trainer's own schedule code, without training steps; ``first_steps``,
``window`` and ``traced`` then run ``Trainer.run``.  Nothing else of the
program is called: it is reached through the Trainer's attributes (the
field's parameters, the optimiser's moments, the two generators), which a
later change may give a public form."""
from __future__ import annotations

import copy
import time

import numpy as np
import torch
from torch.profiler import record_function

from joint_tensorf_tpu_torch.config.options import Options
from joint_tensorf_tpu_torch.data.base import SceneData
from joint_tensorf_tpu_torch.geometry import lie, poses as pose_ops
from joint_tensorf_tpu_torch.train.trainer import Trainer

ADAM_B1 = 0.9    # the moments the optimiser keeps (train/optim.adam_update)


class SpanTrainer(Trainer):
    """The Trainer with a host span around each call of the step."""
    spans = False

    def _step(self, cfg, view_sel, ray_idx, scalars, **kw):
        t0 = time.perf_counter()
        if self.spans:
            with record_function("bench.train_step"):
                out = super()._step(cfg, view_sel, ray_idx, scalars, **kw)
        else:
            out = super()._step(cfg, view_sel, ray_idx, scalars, **kw)
        self.step_s.append(time.perf_counter() - t0)
        return out


def _params(trainer) -> dict:
    out = dict(trainer.state.field.named_parameters())
    out["se3_refine"] = trainer.state.se3_refine
    return out


@torch.no_grad()
def build(inputs, device) -> SpanTrainer:
    """The Trainer at the cell's first iteration: the benchmark's weights
    and pose noise installed at the initial resolution, then every
    schedule update before the first iteration (upsamples, alpha masks,
    budget probes, learning rates), then its two generators seeded from
    the run's seed."""
    opt = Options(copy.deepcopy(inputs.opt))
    V, _, H, W = inputs.images.shape
    data = SceneData(images=inputs.images, poses=inputs.poses,
                     intr=inputs.intr, intr_inv=inputs.intr_inv,
                     near_far=tuple(float(v) for v in
                                    opt.nerf.depth.range), H=H, W=W)
    trainer = SpanTrainer(opt, data, device=device)
    trainer.step_s = []
    params = dict(trainer.state.field.named_parameters())
    if set(params) != set(inputs.weights):
        raise ValueError(f"the field's parameters {sorted(params)} are not "
                         f"the benchmark's {sorted(inputs.weights)}")
    for k, p in params.items():
        if tuple(p.shape) != tuple(inputs.weights[k].shape):
            raise ValueError(f"{k}: the field holds {tuple(p.shape)}, the "
                             f"benchmark {tuple(inputs.weights[k].shape)}")
        p.copy_(inputs.weights[k])
    if inputs.noise_se3 is not None:
        trainer.pose_noise = lie.se3_to_SE3(inputs.noise_se3.to(device))
        trainer.pose_base = pose_ops.compose([trainer.pose_noise,
                                              trainer.gt_poses])
        trainer._refresh_bbox_k()
    for it in range(inputs.start_it):
        trainer.it = it
        trainer._update_schedule()
    trainer.it = inputs.start_it
    trainer.rng_np = np.random.default_rng(inputs.seed)
    trainer.generator.manual_seed(inputs.seed)
    return trainer


def first_steps(trainer, n: int, log_every: int) -> dict:
    """The first ``n`` steps through Trainer.run -> the program's side of
    the comparison: each step's loss, the norm of each leaf's first
    gradient as Adam received it (its first moment after one step over
    1 - b1; the moments start at zero) and the norm of each leaf's change
    over the ``n`` steps."""
    before = {k: v.detach().to("cpu", copy=True)
              for k, v in _params(trainer).items()}
    losses, grads = [], {}

    def on_step(tr, metrics):
        if metrics is None:
            return
        losses.append(metrics["loss"].detach().clone())
        if len(losses) == 1:
            moments = dict(tr.state.scene_opt.mu)
            moments["se3_refine"] = tr.state.pose_opt.mu["se3_refine"]
            for k, m in moments.items():
                grads[k] = torch.linalg.vector_norm(m) / (1 - ADAM_B1)

    trainer.run(max_iter=trainer.it + n, log_every=log_every,
                on_step=on_step)
    change = {k: float(torch.linalg.vector_norm(
        v.detach() - before[k].to(v.device)))
        for k, v in _params(trainer).items()}
    return {"losses": [float(x) for x in losses],
            "grad_norms": {k: float(v) for k, v in grads.items()},
            "change_norms": change}


def window(trainer, seconds: float, chunk: int, log_every: int) -> dict:
    """Trainer.run in chunks of ``chunk`` iterations until ``seconds`` of
    host time have passed, then one synchronise.  A CUDA event recorded
    after every step gives each step's interval on the device's timeline
    without stalling the loop."""
    cuda = trainer.device.type == "cuda"
    events, rays, losses = [], [], []

    def on_step(tr, metrics):
        if metrics is None:
            return
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        rays.append(tr.rays_per_step)
        losses.append(metrics["loss"].detach())

    if cuda:
        torch.cuda.synchronize()
        first = torch.cuda.Event(enable_timing=True)
        first.record()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        trainer.run(max_iter=trainer.it + chunk, log_every=log_every,
                    on_step=on_step)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps_ms = ([first.elapsed_time(events[0])]
                + [a.elapsed_time(b) for a, b in zip(events, events[1:])]
                if cuda else [])
    finite = torch.isfinite(torch.stack(losses)).cpu()
    return {"seconds": t1 - t0, "rays": int(sum(rays)), "steps": len(rays),
            "step_ms": steps_ms, "failed": int((~finite).sum())}


def traced(trainer, n_steps: int, log_every: int, trace_path: str) -> dict:
    """``n_steps`` iterations of Trainer.run (with the step's sample
    statistics) under torch.profiler, between two synchronises inside the
    range ``bench.window``; the benchmark's host spans are
    ``bench.iteration`` (one iteration, from the end of the last) and
    ``bench.train_step`` (the call of Trainer._step)."""
    from torch.profiler import ProfilerActivity, profile

    trainer.spans = True
    trainer.step_s = []
    iter_s, stats = [], []
    state = {}

    def open_iteration():
        rf = record_function("bench.iteration")
        rf.__enter__()
        state["rf"], state["t"] = rf, time.perf_counter()

    def on_step(tr, metrics):
        if metrics is not None:
            stats.append({k: v for k, v in metrics.items()
                          if k.endswith("_frac")})
            return
        state["rf"].__exit__(None, None, None)
        iter_s.append(time.perf_counter() - state["t"])
        open_iteration()

    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            open_iteration()
            trainer.run(max_iter=trainer.it + n_steps, log_every=log_every,
                        on_step=on_step, stats=True)
            state["rf"].__exit__(None, None, None)
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
    trainer.spans = False
    prof.export_chrome_trace(trace_path)
    return {"prof": prof, "iter_s": iter_s, "step_s": list(trainer.step_s),
            "stats": [{k: float(v) for k, v in s.items()} for s in stats],
            "host_window_s": t1 - t0, "steps": n_steps,
            "rays": trainer.rays_per_step * n_steps}
