"""The system under test, driven as users run it: a model's trainer
(models/<model>.py ``build``) and its own ``run`` loop.  ``first_steps``,
``window`` and ``traced`` know nothing of the model but this trainer
contract:

- ``run(max_iter, log_every, on_step=None, stats=False)`` trains until
  iteration ``max_iter`` and calls ``on_step(trainer, metrics)`` after each
  step, with its metrics as 0-d device tensors (``loss`` among them, with
  ``stats`` the sample statistics ``*_frac`` too), then ``on_step(trainer,
  None)`` once the iteration's schedule update is done;
- ``it``: the next iteration; ``rays_per_step``: the rays of the last
  step; ``device``: the torch.device it trains on;
- ``spans``: while true, each step runs inside the host range
  ``bench.train_step``; ``step_s``: a list to which each step appends its
  host seconds.

The leaves ``first_steps`` compares come from the model's ``params`` and
``first_grad_norms``."""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function


def first_steps(model, trainer, n: int, log_every: int) -> dict:
    """The first ``n`` steps through the trainer's ``run`` -> the program's
    side of the comparison: each step's loss, the norm of each leaf's first
    gradient as the optimiser received it (the model's ``first_grad_norms``
    after the first step) and the norm of each leaf's change over the ``n``
    steps."""
    before = {k: v.detach().to("cpu", copy=True)
              for k, v in model.params(trainer).items()}
    losses, grads = [], {}

    def on_step(tr, metrics):
        if metrics is None:
            return
        losses.append(metrics["loss"].detach().clone())
        if len(losses) == 1:
            grads.update(model.first_grad_norms(tr))

    trainer.run(max_iter=trainer.it + n, log_every=log_every,
                on_step=on_step)
    change = {k: float(torch.linalg.vector_norm(
        v.detach() - before[k].to(v.device)))
        for k, v in model.params(trainer).items()}
    return {"losses": [float(x) for x in losses],
            "grad_norms": {k: float(v) for k, v in grads.items()},
            "change_norms": change}


def window(trainer, seconds: float, chunk: int, log_every: int) -> dict:
    """The trainer's ``run`` in chunks of ``chunk`` iterations until ``seconds`` of
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
    """``n_steps`` iterations of the trainer's ``run`` (with the step's
    sample statistics) under torch.profiler, between two synchronises inside the
    range ``bench.window``; the benchmark's host spans are
    ``bench.iteration`` (one iteration, from the end of the last) and
    ``bench.train_step`` (each step, the trainer's ``spans``)."""
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
