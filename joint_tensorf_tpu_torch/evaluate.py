"""Evaluation entry point of the port (counterpart of the repository's
evaluate.py:19-268, for ``model: bat``, ``l2g_bat``, ``tensorf``,
``barf`` and ``nerf``).

    python -m joint_tensorf_tpu_torch.evaluate --yaml=configs/bat_blender_VM.yaml \
        [--ckpt=output/<group>/<name>/model.ckpt.npz] [--device=cpu] \
        [--generate_video=false] [--generate_pose_video=false] [--pdb] \
        [--key=value ...]

Restores the checkpoint (either package's).  With BAT (and L2G-BAT,
whose training poses are its registered ones) it writes the training
poses' errors after sim(3) alignment (``quant_pose.txt``: view, rotation
in radians, translation), aligns the test poses into the learned frame
and refines each by test-time photometric optimisation when
``optim.test_photo`` is set (NDC rays under ``camera.ndc``; on LLFF
captures blurred by ``optim.test_kernel_schedule``); TensoRF renders the
test views at their GT poses and writes no pose file.  BARF and MLP-NeRF
restore the simple checkpoint and go the same way, BARF's test-time
optimisation by make_barf_test_time_optimizer at the constant
optim.lr_pose (as evaluate.py passes it), n_rays rays a step; they have
no compaction caps, so no clip rates.  A dataset without
a test split (LLFF-style captures name their held-out frames "val") is
evaluated on its val split.  Then it measures the static caps' clip
rates, renders the test views and writes per-view PSNR / SSIM
(``quant.txt``) and their means with the clip rates and, with BAT, the
pose errors (``quant_eval.json``, also ``summary.json``).  LPIPS is not
computed (``lpips_note`` says so).

The visual outputs, in evaluate.py's order (viz/):

* with pose optimisation (BAT, L2G-BAT, BARF), ``poses.png``: the
  aligned training poses against GT, after quant_pose.txt;
* with ``generate_video`` (on unless set false), after summary.json: an
  orbit of ``video_n_frames`` views (60 unless set) around
  data.scene_bbox at the first test view's intrinsics, rendered by
  render_views, as ``novel_views.mp4`` at 15 frames a second;
* with pose optimisation and ``generate_pose_video`` (on unless set
  false), the pose plot of every ``model_it{N}.ckpt.npz`` snapshot as
  ``poses/<N>.png``, assembled into ``poses.mp4``; the final checkpoint
  is restored after it;
* ``test_renders/rgb_{i}.png`` of the first 8 test views.

Which files appear depends on the installed packages, as in the JAX
package: a video is an mp4 when imageio has its ffmpeg backend
(imageio_ffmpeg), else ``<stem>_frames/NNNN.png`` when imageio imports,
else ``<stem>_frames/frames.npz``; the pose plot and the pose video's
frames need matplotlib (without it, ``[vis] pose plot skipped: ...`` and
``[video] pose video failed: ...`` are printed); the poses.mp4 frames are
read back and the PNG dump written with imageio (without it, the frame
directory stands for the video and ``[vis] skipped image dump: ...`` is
printed).

Runs on ``cuda`` unless ``--device=cpu`` is given.  ``--pdb`` opens a
post-mortem debugger on an exception (utils/cli.py).
"""
from __future__ import annotations

import json
import os
import sys


def main(argv) -> dict:
    """Run the evaluation; returns the quant_eval.json dict."""
    yaml_path, ckpt_path, device, rest = None, None, None, []
    for a in argv:
        if a.startswith("--yaml="):
            yaml_path = a.split("=", 1)[1]
        elif a.startswith("--ckpt="):
            ckpt_path = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not yaml_path:
        raise SystemExit("usage: python -m joint_tensorf_tpu_torch.evaluate "
                         "--yaml=<cfg> [--ckpt=...] [--device=cpu]")

    import numpy as np
    import torch

    from .config import set_options
    from .data import load_dataset
    from .geometry import align as align_lib
    from .metrics import lpips_fn, psnr, ssim
    from .pose.test_optim import (blur_of_test_kernel,
                                  make_barf_test_time_optimizer,
                                  make_test_time_optimizer, render_config)
    from .train.barf_trainer import BarfTrainer
    from .train.checkpoint import restore_checkpoint, restore_simple_checkpoint
    from .train.l2g_trainer import L2GTrainer
    from .train.trainer import Trainer
    from .utils.logging import MetricLogger

    # generate_pose_video is read with a default in JAX's evaluate.py and
    # stands in no config file
    opt = set_options(yaml_path, rest, allow_new_keys=("generate_pose_video",))
    is_mlp = opt.model in ("barf", "nerf")
    pose_optimizing = opt.model in ("bat", "l2g_bat", "barf")
    out_dir = os.path.join(opt.get("output_root", "output"),
                           str(opt.get("group", "default")),
                           str(opt.get("name", "run")))
    ckpt_path = ckpt_path or os.path.join(out_dir, "model.ckpt.npz")

    train_data = load_dataset(opt, "train", subset=opt.data.get("train_sub"),
                              device=device)
    try:
        test_data = load_dataset(opt, "test", subset=opt.data.get("test_sub"),
                                 device=device)
    except FileNotFoundError:
        test_data = load_dataset(opt, "val", subset=opt.data.get("val_sub"),
                                 device=device)
    if is_mlp:
        trainer = BarfTrainer(opt, train_data, device=device)
        restore_fn = restore_simple_checkpoint
    else:
        trainer = (L2GTrainer if opt.model == "l2g_bat" else Trainer)(
            opt, train_data, device=device)
        restore_fn = restore_checkpoint
    restore_fn(ckpt_path, trainer)
    desc = "" if is_mlp else f" res={trainer.resolution}"
    dev = trainer.device
    print(f"[ckpt] restored it={trainer.it}{desc}", flush=True)

    results = {"iters": trainer.it}
    os.makedirs(out_dir, exist_ok=True)
    test_pose = torch.as_tensor(test_data.poses, device=dev)
    if pose_optimizing:
        err = trainer.pose_error()
        results.update(err)
        print("--------------------------")
        print("rot:   {:8.3f}".format(err["rot_deg"]))
        print("trans: {:10.5f}".format(err["trans"]))
        print("--------------------------", flush=True)
        pose, pose_GT = trainer.get_all_training_poses()
        aligned, sim3 = align_lib.prealign_cameras(pose, pose_GT)
        test_pose = align_lib.align_test_pose(test_pose, sim3)
        r_err, t_err = align_lib.evaluate_camera_alignment(aligned, pose_GT)
        with open(os.path.join(out_dir, "quant_pose.txt"), "w") as f:
            for i, (r, t) in enumerate(zip(r_err.cpu().numpy(),
                                           t_err.cpu().numpy())):
                f.write(f"{i} {r} {t}\n")
        try:
            from .viz.poses_plot import plot_poses_3d

            plot_poses_3d(os.path.join(out_dir, "poses.png"), aligned,
                          pose_GT, title=f"aligned vs GT (it={trainer.it})")
        except Exception as e:   # noqa: BLE001 - optional, as in evaluate.py
            print(f"[vis] pose plot skipped: {e}", flush=True)

    V, H, W = test_data.n_views, test_data.H, test_data.W
    images = torch.as_tensor(test_data.images, device=dev)
    target = images.reshape(V, 3, -1).transpose(1, 2)
    intr = torch.as_tensor(test_data.intr, device=dev)
    intr_inv = torch.as_tensor(test_data.intr_inv, device=dev)

    # ---- test-time photometric pose optimisation
    seed = int(opt.get("seed", 0))
    if is_mlp and pose_optimizing and opt.optim.get("test_photo", False):
        optimize = make_barf_test_time_optimizer(
            trainer, H, W, n_rays=int(opt.nerf.n_rays),
            test_iter=int(opt.optim.test_iter), lr=float(opt.optim.lr_pose),
            generator=torch.Generator(device=dev).manual_seed(seed + 7))
        refined = []
        for i in range(V):
            p, loss = optimize(test_pose[i], target[i], intr[i], intr_inv[i])
            refined.append(p)
            print(f"[test-optim] view {i}: final loss {loss:.5f}", flush=True)
        test_pose = torch.stack(refined)
    elif pose_optimizing and opt.optim.get("test_photo", False):
        blur, sched = blur_of_test_kernel(opt)
        optimize = make_test_time_optimizer(
            trainer.vm_cfg, render_config(trainer), H, W,
            n_rays=trainer._n_rays(), test_iter=int(opt.optim.test_iter),
            lr_init=float(opt.optim.lr_pose_test),
            lr_end=float(opt.optim.lr_pose_test_end),
            generator=torch.Generator(device=dev).manual_seed(seed + 7),
            blur=blur, test_kernel_schedule=sched)
        refined = []
        for i in range(V):
            p, loss = optimize(trainer.state.field, trainer.alpha_mask,
                               test_pose[i], target[i], intr_inv[i],
                               trainer._near_far(), intr=intr[i])
            refined.append(p)
            print(f"[test-optim] view {i}: final loss {loss:.5f}", flush=True)
        test_pose = torch.stack(refined)

    # ---- full renders + metrics
    if not is_mlp:
        clip = trainer.eval_clip_stats(test_pose, intr_inv)
        results["clip_stats"] = clip
        if clip["compact_clip_rate"] > 0 or clip["app_k_clip_rate"] > 0:
            print(f"[eval] WARNING static-cap clipping: {clip}")
        else:
            print(f"[eval] compaction caps exact on probe rays: {clip}")
    rgb, _, _ = trainer.render_views(test_pose, test_data.intr, intr_inv)
    per_view = []
    for i in range(V):
        row = {"view": i, "psnr": float(psnr(rgb[i], target[i])),
               "ssim": float(ssim(rgb[i].reshape(H, W, 3),
                                  target[i].reshape(H, W, 3)))}
        per_view.append(row)
        print(f"[eval] view {i}: PSNR {row['psnr']:.2f} "
              f"SSIM {row['ssim']:.4f}", flush=True)
    results["psnr"] = float(np.mean([r["psnr"] for r in per_view]))
    results["ssim"] = float(np.mean([r["ssim"] for r in per_view]))
    if lpips_fn() is None:
        results["lpips_note"] = ("unavailable: LPIPS needs the lpips package "
                                 "and AlexNet weights, not part of the port")

    with open(os.path.join(out_dir, "quant.txt"), "w") as f:
        for r in per_view:
            f.write(json.dumps(r) + "\n")
    with open(os.path.join(out_dir, "quant_eval.json"), "w") as f:
        json.dump(results, f, indent=2)
    logger = MetricLogger(out_dir, opt)
    logger.summary(results)
    logger.close()
    print("[done]", json.dumps(results), flush=True)

    # ---- novel-view video: an orbit around the scene box
    if opt.get("generate_video", True):
        from .viz.novel_views import novel_view_around_bbox
        from .viz.video import write_video

        n_frames = int(opt.get("video_n_frames", 60))
        novel = novel_view_around_bbox(opt.data.scene_bbox, n=n_frames,
                                       device=dev)
        rgb_nv, _, _ = trainer.render_views(
            novel, intr[:1].expand(n_frames, 3, 3),
            intr_inv[:1].expand(n_frames, 3, 3))
        frames = rgb_nv.reshape(n_frames, H, W, 3).cpu().numpy()
        vid_path = write_video(os.path.join(out_dir, "novel_views.mp4"),
                               frames, fps=15)
        print(f"[video] wrote {vid_path}", flush=True)

    # ---- pose-trajectory video over the per-iteration snapshots
    if pose_optimizing and opt.get("generate_pose_video", True):
        from .viz.pose_video import generate_pose_video

        try:
            vid = generate_pose_video(out_dir, trainer, restore_fn)
        except Exception as e:   # noqa: BLE001 - optional, as in evaluate.py
            vid = None
            print(f"[video] pose video failed: {e}", flush=True)
        if vid:
            print(f"[video] wrote {vid}", flush=True)
            restore_fn(ckpt_path, trainer)      # back to the final state
        else:
            print("[video] no per-iter snapshots; pose video skipped "
                  "(set freq.ckpt to record them)", flush=True)

    # ---- the first renders as PNGs
    vis_dir = os.path.join(out_dir, "test_renders")
    os.makedirs(vis_dir, exist_ok=True)
    try:
        import imageio.v2 as imageio

        for i in range(min(V, 8)):
            img = rgb[i].reshape(H, W, 3).cpu().numpy()
            imageio.imwrite(os.path.join(vis_dir, f"rgb_{i}.png"),
                            (img * 255).astype(np.uint8))
    except Exception as e:   # noqa: BLE001 - optional, as in evaluate.py
        print(f"[vis] skipped image dump: {e}", flush=True)
    return results


if __name__ == "__main__":
    from .utils import run_cli

    run_cli(main, sys.argv[1:])
