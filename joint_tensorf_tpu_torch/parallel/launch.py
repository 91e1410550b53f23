"""Start D ranks of a data-parallel run from one program, and the work
they run.

``spawn(fn, D, payload)`` starts D processes with
torch.multiprocessing (the spawn method), each in a process group over a
file store in a fresh temporary directory (no TCP port, so that several
programs on one host cannot collide), and calls ``fn(payload, device)`` on
every rank; it returns the ranks' results in rank order.  Each rank runs
with one CPU thread.  A rank that raises makes spawn raise with that
rank's traceback; a run that outlasts ``timeout_s`` is terminated and
raises TimeoutError.  The collectives time out after ``timeout_s`` too.

The work a rank runs lives here, so that a child imports only this
package: run_jobs executes a list of jobs on every rank and returns, for
each, what the caller compares:

* ``step``: one sharded train step (BAT / TensoRF, or L2G) from a state
  in the converter's numpy form (convert.py) with the inputs and draws
  given -> the reduced metrics and gradients (the factors' gathered under
  the comp layout), the state after the step, and the collectives and
  kernel launches the step made;
* ``trainer``: a Trainer (or L2GTrainer) from a config and options, for a
  number of iterations (each from a given converter-form state with
  pre-drawn jitter, if given), or for one step from each snapshot of
  another run, held against that run's loss and gradients of the step ->
  per iteration the metrics, the step's configuration, the collectives
  and their bytes, the kernel launches and on a card the peak memory
  (and the budgets after the schedule update), and
  the state, budgets and replica checksums (by the group that holds
  them equal) at the end; optionally a checkpoint restored before the
  first step (``restore``), the first view rendered by render_views at
  the end (``render``: the chunk), and a checkpoint saved by rank 0 and
  restored on every rank (``save``).

snapshot / load_snapshot carry a trainer's whole step-relevant state
(model state in the converter's unsharded form, masks, budgets, blur
cache, schedule and both generators) from one run to another, so that a
run on D ranks, in either layout, can take the same step from the same
state as a run on one.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import initialize_distributed


def _child(rank, fn, nprocs, tmp, backend, device, payload, timeout_s):
    torch.set_num_threads(1)
    initialize_distributed(f"file://{os.path.join(tmp, 'store')}", nprocs,
                           rank, backend=backend, device=device,
                           timeout_s=timeout_s)
    try:
        out = fn(payload, device)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, payload, backend: str = "gloo", device="cpu",
          timeout_s: float = 600.0) -> list:
    """Run ``fn(payload, device)`` on ``nprocs`` ranks (see the module
    docstring); ``device`` is every rank's (e.g. "cpu", or "cuda:0" for
    several gloo ranks on one card)."""
    with tempfile.TemporaryDirectory(prefix="jtf_spawn_") as tmp:
        ctx = mp.start_processes(
            _child, args=(fn, nprocs, tmp, backend, str(device), payload,
                          timeout_s),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10.0)
                raise TimeoutError(f"spawn: {nprocs} ranks of {fn.__name__} "
                                   f"ran over {timeout_s} s")
        out = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ------------------------------------------------------------ snapshots
# the trainer's attributes a snapshot carries besides its model state
_SNAPSHOT_ATTRS = (
    "pose_base", "pose_noise", "alpha_mask", "alpha_mask_blur",
    "compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn",
    "_blur_mask_built_at", "blurred_images", "edge_masks", "_blur_cache_at",
    "it", "resolution", "n_samples", "n_voxels", "n_voxel_list",
    "alphamask_resolution", "resolution_scale", "lr_index", "lr_basis",
    "tv_density_weight", "tv_color_weight")


def _is_l2g(trainer) -> bool:
    return hasattr(trainer, "l2g_cfg")


def snapshot(trainer, path: str):
    """Save ``trainer``'s step-relevant state to ``path`` (torch.save; the
    model state gathered into the converter's form, so every rank of the
    comp layout calls it; rank 0 writes)."""
    from .. import convert

    snap = {k: getattr(trainer, k) for k in _SNAPSHOT_ATTRS}
    snap["state"] = (convert.l2g_to_numpy if _is_l2g(trainer)
                     else convert.to_numpy)(trainer.state)
    snap["rng_state"] = trainer.rng_np.bit_generator.state
    snap["generator_state"] = trainer.generator.get_state()
    if trainer.mesh is None or trainer.mesh.is_main:
        torch.save(snap, path)


def load_snapshot(trainer, path: str):
    """Load a snapshot into ``trainer`` (onto its device; under the comp
    layout this rank's component blocks)."""
    from .. import convert

    snap = torch.load(path, map_location=trainer.device, weights_only=False)
    for k in _SNAPSHOT_ATTRS:
        setattr(trainer, k, snap[k])
    if _is_l2g(trainer):
        trainer.state = convert.l2g_state_from_numpy(
            snap["state"], trainer.vm_cfg, trainer.l2g_cfg,
            device=trainer.device, comp=trainer.comp)
    else:
        trainer.state, _ = convert.train_state_from_numpy(
            snap["state"], trainer.vm_cfg, device=trainer.device,
            comp=trainer.comp)
    trainer.rng_np.bit_generator.state = snap["rng_state"]
    trainer.generator.set_state(snap["generator_state"].cpu())
    trainer.last_step_config = None
    trainer._verify_replicas(f"loading {path}")


# ------------------------------------------------------------ jobs
_BUDGETS = ("compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")


def _t(x, device):
    return torch.as_tensor(np.asarray(x), device=device)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _whole_grads(grads: dict, field) -> dict:
    """The gradients as numpy, the factor blocks' gathered under the comp
    layout."""
    from .. import convert

    return _numpy(convert.gathered(field, grads))


def _counts(counts: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in counts.items()
            if v - before.get(k, 0)}


def _step_job(job, mesh, device):
    """One sharded step from a converter-form state."""
    from .. import convert
    from ..models.vm import VMConfig
    from ..ops import cuda_build
    from ..train.l2g import L2GConfig, l2g_train_step
    from ..train.step import StepConfig, StepScalars, train_step

    vm_cfg = VMConfig(**job["vm_cfg"])
    cfg = StepConfig(**job["step_cfg"])
    s = StepScalars(**job["scalars"])
    x = {k: _t(v, device) for k, v in job["inputs"].items()
         if k not in ("bg_coin", "error_draws")}
    kw = dict(jitter=x.get("jitter"), bg_coin=job["inputs"].get("bg_coin"),
              mesh=mesh, stats=bool(job.get("stats")))
    comp = mesh if mesh.comp > 1 else None
    before = dict(mesh.counts)
    launches = dict(cuda_build.LAUNCHES)
    if job.get("l2g_cfg") is not None:
        l2g_cfg = L2GConfig(**job["l2g_cfg"])
        state = convert.l2g_state_from_numpy(job["state"], vm_cfg, l2g_cfg,
                                             device=device, comp=comp)
        draws = job["inputs"].get("error_draws")
        metrics, grads = l2g_train_step(
            state, cfg, l2g_cfg, vm_cfg, x["pose_base"], x["intr"],
            x["intr_inv"], x["images"], x["edges"], x["view_sel"],
            x["ray_idx"], s, error_draws=None if draws is None else tuple(
                _t(d, device) for d in draws), **kw)
        to_numpy = convert.l2g_to_numpy
    else:
        state, pose_base = convert.train_state_from_numpy(
            job["state"], vm_cfg, device=device, comp=comp)
        metrics, grads = train_step(
            state, cfg, vm_cfg, pose_base, x["intr_inv"], x["images"],
            x["edges"], x["view_sel"], x["ray_idx"], s, intr=x.get("intr"),
            **kw)
        to_numpy = convert.to_numpy
    # the step's collectives and launches, before the gathers below
    counts = _counts(mesh.counts, before)
    launched = {k: v - launches[k] for k, v in cuda_build.LAUNCHES.items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _whole_grads(grads, state.field),
            "state": to_numpy(state), "counts": counts,
            "launches": launched, "coords": mesh.coords}


def _trainer_job(job, device):
    """A trainer for ``job["steps"]`` iterations, or one step from each of
    ``job["snapshots"]`` held against ``job["refs"]`` (module
    docstring)."""
    from .. import convert
    from ..config import set_options
    from ..data import load_dataset
    from ..ops import cuda_build
    from ..train import checkpoint as ckpt_lib
    from ..train.l2g_trainer import L2GTrainer
    from ..train.trainer import Trainer
    from . import sharding

    opt = set_options(job["yaml"], list(job.get("args", ())))
    data = load_dataset(opt, "train", device=device)
    make = L2GTrainer if opt.model == "l2g_bat" else Trainer
    to_numpy = (convert.l2g_to_numpy if opt.model == "l2g_bat"
                else convert.to_numpy)
    tr = make(opt, data, device=device)
    captured = []
    step = tr._step

    def capture(*a, **k):
        metrics, grads = step(*a, **k)
        captured.append(grads)
        return metrics, grads

    tr._step = capture
    if job.get("restore"):
        ckpt_lib.restore_checkpoint(job["restore"], tr)
    snaps = job.get("snapshots")
    history = []
    for i in range(len(snaps) if snaps else int(job["steps"])):
        if snaps:
            load_snapshot(tr, snaps[i])
        if job.get("states") is not None:
            # a BAT state in the converter's form; with its pose_base the
            # in-bbox budget is probed anew on those poses
            tr.state, pose_base = convert.train_state_from_numpy(
                job["states"][i], tr.vm_cfg, device=device, comp=tr.comp)
            if pose_base is not None:
                tr.pose_base = pose_base
                tr._refresh_bbox_k()
        kw = {}
        if job.get("jitters") is not None:
            kw["jitter"] = _t(job["jitters"][i], device)
        before = dict(tr.mesh.counts)
        before_bytes = dict(tr.mesh.nbytes)
        launches = dict(cuda_build.LAUNCHES)
        captured.clear()
        if device != "cpu":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        m = tr.train_iteration(**kw)
        if device != "cpu":
            torch.cuda.synchronize(device)
        row = {"it": tr.it, "ms": (time.perf_counter() - t0) * 1e3,
               "metrics": {k: float(v) for k, v in m.items()},
               "launches": {k: v - launches[k]
                            for k, v in cuda_build.LAUNCHES.items()},
               "config": dict(vars(tr.last_step_config)),
               "counts": _counts(tr.mesh.counts, before),
               "bytes": _counts(tr.mesh.nbytes, before_bytes)}
        if device != "cpu":
            row["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        if snaps:
            ref = torch.load(job["refs"][i], map_location=device,
                             weights_only=False)
            whole = {k: torch.as_tensor(g, device=device) for k, g in
                     _whole_grads(captured[0], tr.state.field).items()}
            row["grad_err"] = {
                k: float((g - ref["grads"][k]).abs().max()
                         / ref["grads"][k].abs().max().clamp_min(1e-30))
                for k, g in whole.items()}
            row["loss_ref"] = float(ref["loss"])
            row["bucket_bytes"] = sharding.bucket_bytes(
                list(captured[0].values()))
        else:
            tr._update_schedule()
            row["budgets"] = {k: getattr(tr, k) for k in _BUDGETS}
            row["resolution"] = list(tr.resolution)
            tr.it += 1
        history.append(row)
    tr._verify_replicas("the last step")
    out = {"history": history, "state": to_numpy(tr.state),
           "rank": tr.mesh.rank, "coords": tr.mesh.coords,
           "budgets": {k: getattr(tr, k) for k in _BUDGETS},
           "checksums": {axis or "world": {k: int(sharding.bits_sum(v))
                                           for k, v in tensors.items()}
                         for axis, tensors in tr._replica_groups().items()}}
    if job.get("render"):
        out["render"] = [o.cpu().numpy() for o in tr.render_views(
            tr.pose_base[:1], tr.intr[:1], tr.intr_inv[:1],
            chunk=int(job["render"]))]
    if job.get("save"):
        ckpt_lib.save_checkpoint(job["save"], tr)
        resumed = make(opt, data, device=device)
        ckpt_lib.restore_checkpoint(job["save"], resumed)
        out["resumed_state"] = to_numpy(resumed.state)
        out["resumed_it"] = resumed.it
    return out


def run_jobs(payload: dict, device) -> list:
    """Every job of ``payload["jobs"]`` on this rank (module docstring);
    the step jobs share one mesh of shape ``payload["mesh_shape"]`` over
    ``payload["mesh_axes"]`` (default: rays)."""
    from .mesh import make_mesh

    out = []
    mesh = None
    for job in payload["jobs"]:
        if job["kind"] == "step":
            if mesh is None:
                mesh = make_mesh(payload["mesh_shape"],
                                 payload.get("mesh_axes", ("rays",)),
                                 device=device)
            out.append(_step_job(job, mesh, device))
        elif job["kind"] == "trainer":
            out.append(_trainer_job(job, device))
        else:
            raise ValueError(f"unknown job kind {job['kind']!r}")
    return out
