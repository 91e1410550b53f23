"""Training CLI of the port (counterpart of the repository's train.py:35-184,
for ``model: bat``, ``l2g_bat``, ``tensorf``, ``barf`` and ``nerf``).

    python -m joint_tensorf_tpu_torch.train --yaml=configs/bat_blender_VM.yaml \
        --data.dataset=synthetic [--key=value ...] [--device=cpu] [--pdb]

Loads the config (dotted overrides as in train.py), renders the procedural
scene on the device (or reads a Blender, LLFF, t2 or iPhone scene from
disk), and trains BAT, L2G-BAT or TensoRF through its whole schedule (voxel upsamples,
alpha-mask updates, bbox shrink) on the JAX trainer's default
``tpu:`` path (sample compaction, dense-grid density, two-stage
appearance; ``--tpu.bbox_compact=false --tpu.blur_mask_compact=false
--tpu.densify_density=false --tpu.app_k=null`` turn off all but the
alpha mask's own compaction, which the JAX trainer always runs), or
BARF / MLP-NeRF (train/barf_trainer.py), whose checkpoints are the
simple ones (train/checkpoint.save_simple_checkpoint).

Writes into ``output_root/group/name/``:

* ``options.json`` (the config drift against an existing one is printed
  first, one ``[options]`` line per key);
* ``log.jsonl``: one row per log interval (freq.scalar) with the step's
  metrics, with BAT or BARF the pose errors after sim(3) alignment
  (``rot_deg``, ``trans``) every 4 x freq.scalar iterations, and
  ``val_psnr`` every freq.val iterations (the validation poses aligned
  with BAT or BARF);
* ``model_it{N}.ckpt.npz`` every freq.ckpt iterations (with
  ``model.ckpt.npz``), written on the checkpoint writer thread, and
  ``model.ckpt.npz`` at the end, written once that thread's queue is
  drained (train/checkpoint.py, the JAX layout);
* ``quant.json`` after the final validation: ``wall_s``, ``iters``,
  ``val_psnr``, and with BAT or BARF ``rot_deg``, ``trans``; also
  ``summary.json``, and the first validation view as the image
  ``val/val_rgb`` in TensorBoard (``tb/``) when it is on.

``--resume=true`` continues from ``model.ckpt.npz`` at its stored
iteration.  The validation split is ``val``, or ``test`` with
data.val_on_test; a scene without it on disk validates on the training
views, as train.py does.  It also prints one line per phase transition with the
compaction budgets (the VM trainers).

``--profiling=true`` trains 5 warm-up iterations, then 3 under
torch.profiler, writes the trace to ``torch_trace/trace.json`` (utils/
logging.profile_trace), prints one line naming it and returns without
further training (no log, checkpoint or quant file), as train.py does.
The trace holds the program's own ranges (utils/tracing.py), nested as
listed: ``jt.trainer.schedule`` (with ``jt.trainer.blur_cache`` and
``jt.trainer.blur_mask`` inside), ``jt.trainer.upload``,
``jt.trainer.update_schedule`` and ``jt.trainer.log_point`` from the
trainer; ``jt.step`` with ``jt.step.rays``, ``jt.step.loss``,
``jt.step.backward``, ``jt.step.reduce`` (under a mesh) and
``jt.step.adam`` from the step; ``jt.render`` with ``jt.render.sample``,
``jt.render.density`` and ``jt.render.appearance`` from the renderer
(inside ``jt.step``).  The backward's kernels are launched from
autograd's own thread, so they fall inside ``jt.step.backward`` by time,
not by parent.
``--pdb`` opens a post-mortem debugger on an exception (utils/cli.py).

A config with ``tpu.mesh_shape`` ([D] with a rays axis, as
configs/bat_blender_VM_pod16.yaml, or [R, C] with ``tpu.mesh_axes``
[rays, comp]: the factor components split over C ranks too) trains on D
(R x C) ranks started by a launcher, one process a rank (NCCL on the
cards, one card a rank; gloo on the CPU with --device=cpu):

    python -m torch.distributed.run --nproc_per_node=D \
        -m joint_tensorf_tpu_torch.train --yaml=... [--tpu.mesh_shape=[D]]

Without a launcher such a config raises (parallel/mesh.make_mesh), unless
D is 1.  Every rank trains and validates; only rank 0 prints and writes
the files above (checkpoints included; every rank waits for the final one,
and a restore drains rank 0's queue first).

One departure from train.py: a failed validation (mid-run or final)
stops the run, where train.py catches it and carries on, because a failed
render on the card is a fault to see.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time


def main(argv) -> dict:
    """Run the training; returns the quant.json dict (with profiling,
    {"iters", "trace"})."""
    yaml_path, device, rest = None, None, []
    for a in argv:
        if a.startswith("--yaml="):
            yaml_path = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not yaml_path:
        raise SystemExit("usage: python -m joint_tensorf_tpu_torch.train "
                         "--yaml=configs/<cfg>.yaml [--k=v ...]")

    from ..config import set_options
    from ..config.options import diff_options
    from ..data import load_dataset
    from ..utils.logging import MetricLogger, profile_trace
    from . import checkpoint as ckpt_lib
    from .barf_trainer import BarfTrainer
    from .l2g_trainer import L2GTrainer
    from .trainer import Trainer

    opt = set_options(yaml_path, rest)
    # rank 0 of a launched mesh run (every process is rank 0 without one)
    main_rank = os.environ.get("RANK", "0") == "0"
    log = print if main_rank else (lambda *a, **k: None)
    out_dir = os.path.join(opt.get("output_root", "output"),
                           str(opt.get("group", "default")),
                           str(opt.get("name", "run")))
    os.makedirs(out_dir, exist_ok=True)
    opts_file = os.path.join(out_dir, "options.json")
    if main_rank and os.path.exists(opts_file):
        with open(opts_file) as f:
            saved = json.load(f)
        drift = diff_options(saved, json.loads(
            json.dumps(opt.to_dict(), default=str)))
        if drift:
            print(f"[options] config drift vs saved {opts_file}:")
            for line in drift:
                print(f"[options]   {line}")
    if main_rank:
        with open(opts_file, "w") as f:
            json.dump(opt.to_dict(), f, indent=2, default=str)

    log(f"[data] rendering {opt.data.dataset} "
          f"{opt.data.image_size} x {opt.data.get('n_views', 12)} views",
          flush=True)
    data = load_dataset(opt, "train", subset=opt.data.get("train_sub"),
                        device=device)
    val_split = "test" if opt.data.get("val_on_test") else "val"
    try:
        val_data = load_dataset(opt, val_split,
                                subset=opt.data.get("val_sub"), device=device)
    except FileNotFoundError as e:
        log(f"[data] no val split ({e}); validating on train views")
        val_data = data
    is_mlp = opt.model in ("barf", "nerf")
    if is_mlp:
        trainer = BarfTrainer(opt, data, val_data, device=device)
        desc = f"mlp L_3D={trainer.mlp_cfg.L_3D}"
        pose_optimizing = trainer.is_barf
        save, restore = (ckpt_lib.save_simple_checkpoint,
                         ckpt_lib.restore_simple_checkpoint)
    else:
        trainer = (L2GTrainer if opt.model == "l2g_bat" else Trainer)(
            opt, data, val_data, device=device)
        desc = f"res={trainer.resolution}"
        pose_optimizing = trainer.is_bat
        save, restore = ckpt_lib.save_checkpoint, ckpt_lib.restore_checkpoint
    log(f"[train] {opt.model} | device={trainer.device} "
          f"views={data.n_views} {desc} n_samples={trainer.n_samples} "
          f"max_iter={trainer.max_iter}", flush=True)

    ckpt_file = os.path.join(out_dir, "model.ckpt.npz")
    if opt.get("resume") and os.path.exists(ckpt_file):
        restore(ckpt_file, trainer)
        log(f"[resume] restored it={trainer.it}", flush=True)

    if opt.get("profiling"):
        trainer.run(max_iter=trainer.it + 5, log_every=1)      # warm-up
        with (profile_trace(out_dir) if main_rank
              else contextlib.nullcontext()) as trace:
            trainer.run(max_iter=trainer.it + 3, log_every=1)
        log(f"[profiling] trace written to {trace} at it {trainer.it} "
              f"-- exiting (profiling mode does not continue training)",
              flush=True)
        return {"iters": trainer.it, "trace": trace}

    logger = MetricLogger(out_dir, opt) if main_rank else None
    t0 = time.time()
    freq_scalar = int(opt.freq.get("scalar", 200))
    freq_val = int(opt.freq.get("val", 0) or 0)
    freq_ckpt = int(opt.freq.get("ckpt", 0) or 0)
    phase = None if is_mlp else [trainer.resolution, trainer.n_samples, None]

    def on_log(tr, m):
        line = dict(m)
        if pose_optimizing and tr.it % max(1, freq_scalar * 4) == 0:
            line.update(tr.pose_error())
        if freq_val and tr.it > 0 and tr.it % freq_val == 0:
            line["val_psnr"] = tr.validate(val_data)["psnr"]
            log(f"it {tr.it:6d} | VAL psnr {line['val_psnr']:.2f}",
                flush=True)
        if logger:
            logger.log_scalars(line, tr.it)
        if freq_ckpt and tr.it > 0 and tr.it % freq_ckpt == 0:
            # per-iteration snapshots are queued (one writer thread), so
            # the loop does not wait for the disk
            save(ckpt_file, tr, async_write=True, snapshot_path=os.path.join(
                out_dir, f"model_it{tr.it}.ckpt.npz"))
        msg = f"it {tr.it:6d} | loss {m['loss']:.5f} | psnr {m['psnr']:.2f} "
        if not is_mlp:
            msg += f"| lr {tr.lr_index:.2e} "
        msg += f"| {m['wall']:.1f}s"
        if "rot_deg" in line:
            msg += f" | rot {line['rot_deg']:.3f}° trans {line['trans']:.4f}"
        log(msg, flush=True)

    def on_step(tr, m):
        if m is not None:       # after the step; report after the update
            return
        mask_res = (tr.alphamask_resolution if tr.alpha_mask is not None
                    else None)
        now = [tr.resolution, tr.n_samples, mask_res]
        if now != phase:
            phase[:] = now
            aabb = tr.state.field.aabb.cpu().numpy().round(4).tolist()
            log(f"[phase] after it {tr.it}: res={tr.resolution} "
                  f"n_samples={tr.n_samples} mask_res={mask_res} "
                  f"aabb={aabb} compact_k(bbox/mask)="
                  f"{tr.compact_k_bbox}/{tr.compact_k} "
                  f"app_k={tr.app_k_dyn or tr.opt.tpu.get('app_k')}",
                  flush=True)

    if is_mlp:
        trainer.run(log_every=freq_scalar, callback=on_log)
    else:
        trainer.run(log_every=freq_scalar, callback=on_log, on_step=on_step)

    # the checkpoint before the final validation, as in train.py: the
    # queued snapshots first, so that none lands after the final file
    ckpt_lib.wait_for_pending()
    save(ckpt_file, trainer)
    log(f"[ckpt] saved to {ckpt_file}", flush=True)
    val = trainer.validate(val_data)
    result = {"wall_s": time.time() - t0, "iters": trainer.it,
              "val_psnr": val["psnr"]}
    if pose_optimizing:
        result.update(trainer.pose_error())
    if logger:
        H, W = val_data.images.shape[-2:]
        logger.log_image("val_rgb", val["rgb"][0].reshape(H, W, 3),
                         trainer.it, split="val")
        with open(os.path.join(out_dir, "quant.json"), "w") as f:
            json.dump(result, f, indent=2)
        logger.summary(result)
        logger.close()
    log("[done]", json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    from ..utils import run_cli

    run_cli(main, sys.argv[1:])
