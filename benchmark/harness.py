"""One run of one cell: set-up, the measured window (or the traced span),
the correctness comparison, the result.

Set-up (``setup_s``, from the start of the process): the inputs from the
seed, the Trainer at the cell's first iteration, its first steps (the
program's side of the comparison), the warm-up steps.  Then either the
window (end-to-end metrics) or the traced span (per-layer metrics), the
device's peak memory, the program's state freed, and the reference over
the same first steps, whose time counts nowhere.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from . import inputs as inputs_lib
from . import judge, program, spec
from . import trace as trace_lib
from .census import counts
from .census.frozen import device_detail
from .reference import field as ref_field
from .reference.step import Reference

FORBIDDEN = ("jax", "jaxlib", "flax", "joint_tensorf_tpu")


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads (metrics/<name>.py ``read(ctx)``)."""
    cell: spec.Cell
    span: trace_lib.Span
    steps: int
    iter_s: list           # host seconds of each traced iteration
    step_s: list           # host seconds inside Trainer._step
    stats: list            # the step's sample fractions, as floats
    shape: counts.StepShape


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def step_shape(cell: spec.Cell, ref: dict) -> counts.StepShape:
    o = cell.config["options"]
    t, sh = o["arch"]["tensorf"], o["arch"]["shading"]
    layers = ref_field.head_layers(str(sh["model"]), int(sh["app_dim"]),
                                   int(sh["view_pe"]), int(sh["fea_pe"]),
                                   int(sh["mlp_hidden_dim"]))
    return counts.StepShape(
        n_rays=ref["rays"],
        n_valid=statistics.mean(c[0] for c in ref["counts"]),
        n_gated=statistics.mean(c[1] for c in ref["counts"]),
        density_ranks=tuple(int(r) for r in t["density_components"]),
        app_ranks=tuple(int(r) for r in t["color_components"]),
        app_dim=int(sh["app_dim"]), head_layers=tuple(layers.values()),
        planes=tuple(ref["planes"]), lines=tuple(ref["lines"]),
        n_params=int(ref["n_params"]), blur_taps=tuple(ref["blur_taps"]))


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell = spec.cell(root, name)
    opts = cell.config["options"]
    tr = cell.traffic
    log_every = int(opts["freq"]["scalar"])
    if cuda:
        _log(f"[bench] card {device_detail(dev.index or 0)}")
    inputs = inputs_lib.make(opts, seed, cell.start_it, dev,
                             warm_radii=float(cell.config["warm_radii"]))
    trainer = program.build(dataclasses.replace(
        inputs, images=inputs.images.clone()), dev)
    _log(f"[bench] {name}: iteration {trainer.it}, resolution "
         f"{trainer.resolution}, S {trainer.n_samples}, budgets K "
         f"{trainer.compact_k} / bbox {trainer.compact_k_bbox} / blur "
         f"{trainer.compact_k_blur}, app_k {trainer.app_k_dyn}")
    prog = program.first_steps(trainer, int(tr["check_steps"]), log_every)
    trainer.run(max_iter=trainer.it + int(tr["warmup_steps"]),
                log_every=log_every)
    cfg = trainer.last_step_config
    _log(f"[bench] step config: rays {trainer.rays_per_step}, compact_k "
         f"{cfg.compact_k}, app_k {cfg.app_k}, dense grid "
         f"{cfg.densify_density}, blur {cfg.blur is not None}")
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
    ref = Reference(inputs, dev).run(int(tr["check_steps"]))
    _log(f"[bench] reference: {time.perf_counter() - t_ref:.1f} s, samples "
         f"live / gated a step {ref['counts']}")
    read = judge.readings(prog, ref)
    check = judge.checks(read, cell.limits)
    _log(f"[bench] program losses {prog['losses']}, reference "
         f"{ref['losses']} (gaps {read['step_loss_gaps']}); worst "
         f"gradient leaf {read['grad_leaf']}, "
         f"change leaf {read['change_leaf']}, left out {read['left_out']}")

    if trace:
        ctx = Context(cell=cell, span=span, steps=got["steps"],
                      iter_s=got["iter_s"], step_s=got["step_s"],
                      stats=got["stats"], shape=step_shape(cell, ref))
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
