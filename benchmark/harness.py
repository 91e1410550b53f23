"""One run of one cell: set-up, the measured window (or the traced span),
the correctness comparison, the result.

Set-up (``setup_s``, from the start of the process): the inputs from the
seed, the model's trainer at the cell's first iteration, its first steps
(the program's side of the comparison), the warm-up steps.  Then either the
window (end-to-end metrics) or the traced span (per-layer metrics), the
device's peak memory, the program's state freed, and the reference over
the same first steps, whose time counts nowhere.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import judge, program, spec
from . import trace as trace_lib
from .census.frozen import device_detail

@dataclasses.dataclass
class Context:
    """What a per-layer metric reads (metrics/<name>.py ``read(ctx)``)."""
    cell: spec.Cell
    span: trace_lib.Span
    steps: int
    iter_s: list           # host seconds of each traced iteration
    step_s: list           # host seconds of each traced step
    stats: list            # the step's sample fractions, as floats
    shape: object          # the model's step_shape(cell, reference)
    census: object         # the model's census, which counts ``shape``


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell = spec.cell(root, name)
    model = cell.model
    opts = cell.config["options"]
    tr = cell.traffic
    log_every = int(opts["freq"]["scalar"])
    if cuda:
        _log(f"[bench] card {device_detail(dev.index or 0)}")
    inputs = model.make_inputs(
        opts, seed, cell.start_it, dev,
        warm_radii=float(cell.config.get("warm_radii") or 0.0))
    trainer = model.build(inputs, dev)
    _log(f"[bench] {name}: {model.describe(trainer)}")
    prog = program.first_steps(model, trainer, int(tr["check_steps"]),
                               log_every)
    trainer.run(max_iter=trainer.it + int(tr["warmup_steps"]),
                log_every=log_every)
    _log(f"[bench] {model.describe(trainer)}")
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if trace:
        tdir = os.environ.get("TMPDIR") or tempfile.gettempdir()
        got = program.traced(trainer, int(tr["trace_steps"]), log_every,
                             os.path.join(tdir, f"benchmark_trace_{name}"
                                                f".json"))
        span = trace_lib.reduce(got["prof"]) if cuda else None
        attempted, failed = got["steps"], 0
        rate = got["rays"] / got["host_window_s"]
        _log(f"[bench] traced: {got['steps']} steps, {got['rays']} rays in "
             f"{got['host_window_s']:.4f} s ({rate:.1f} rays/s under the "
             f"profiler)")
    else:
        got = program.window(trainer, seconds, int(tr["chunk_steps"]),
                             log_every)
        attempted, failed = got["steps"], got["failed"]
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = model.Reference(inputs, dev).run(int(tr["check_steps"]))
    _log(f"[bench] reference: {time.perf_counter() - t_ref:.1f} s, "
         + ", ".join(f"{k} {v}" for k, v in ref.items()
                     if k not in ("losses", "grad_norms", "change_norms")))
    read = judge.readings(prog, ref)
    check = judge.checks(read, cell.limits)
    _log(f"[bench] program losses {prog['losses']}, reference "
         f"{ref['losses']} (gaps {read['step_loss_gaps']}); worst "
         f"gradient leaf {read['grad_leaf']}, "
         f"change leaf {read['change_leaf']}, left out {read['left_out']}; "
         + ", ".join(f"{k} {read[k]!r}" for k in judge.NUMBERS))

    if trace:
        ctx = Context(cell=cell, span=span, steps=got["steps"],
                      iter_s=got["iter_s"], step_s=got["step_s"],
                      stats=got["stats"], shape=model.step_shape(cell, ref),
                      census=model.census)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(root, m["name"])(ctx) if cuda else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == "train_rays_per_s":
                value = got["rays"] / got["seconds"]
            elif m["name"] == "train_step_ms":
                value = 1000 * got["seconds"] / got["steps"]
            elif m["name"] == "step_ms_p95":
                value = float(np.percentile(got["step_ms"], 95)) \
                    if got["step_ms"] else None
            else:
                raise KeyError(f"no end-to-end metric {m['name']!r} in "
                               f"the harness")
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": judge.correct(check), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if cuda else dev.type),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace and span is not None:
        result["device"].update(busy_s=span.busy_s, window_s=span.window_s)
        result["breakdown"] = {"device_ops": span.device_ops,
                               "idle_gaps": span.idle_gaps}
    result["checks"] = check
    return result
