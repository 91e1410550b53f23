"""Pose-trajectory video over training snapshots
(counterpart of joint_tensorf_tpu/viz/pose_video.py:27-78; reference
barf.py:198-245): restore every ``model_it{N}.ckpt.npz`` snapshot, plot
its sim(3)-aligned training poses against GT, and assemble the frames
into ``poses.mp4`` with viz.video.write_video.
"""
from __future__ import annotations

import glob
import os
import re

import numpy as np


def _snapshot_paths(out_dir: str):
    """Sorted [(it, path)] of the per-iteration snapshots in out_dir."""
    snaps = []
    for p in glob.glob(os.path.join(out_dir, "model_it*.ckpt.npz")):
        m = re.search(r"model_it(\d+)\.ckpt\.npz$", p)
        if m:
            snaps.append((int(m.group(1)), p))
    return sorted(snaps)


def generate_pose_video(out_dir: str, trainer, restore_fn,
                        fps: int = 10) -> str | None:
    """Write ``<out_dir>/poses/<it>.png`` for every snapshot and assemble
    them into ``<out_dir>/poses.mp4`` (or write_video's fallback).

    ``restore_fn(path, trainer)`` restores a snapshot in place
    (train.checkpoint.restore_checkpoint or restore_simple_checkpoint, as
    the trainer needs).  The trainer is left on the LAST snapshot; a
    caller that needs the final state restores model.ckpt.npz afterwards,
    as the JAX package's evaluate does.  Returns the path written, the
    frame directory when the frames cannot be read back (no imageio), or
    None without snapshots."""
    from ..geometry import align as align_lib
    from .poses_plot import plot_poses_3d
    from .video import write_video

    snaps = _snapshot_paths(out_dir)
    if not snaps:
        return None
    frame_dir = os.path.join(out_dir, "poses")
    os.makedirs(frame_dir, exist_ok=True)
    frame_paths = []
    for it, path in snaps:
        restore_fn(path, trainer)
        pose, pose_gt = trainer.get_all_training_poses()
        try:
            aligned, _ = align_lib.prealign_cameras(pose, pose_gt)
        except Exception:   # a failed SVD: the identity alignment, as JAX
            aligned = pose
        fp = os.path.join(frame_dir, f"{it}.png")
        plot_poses_3d(fp, aligned, pose_gt, title=f"it {it}")
        frame_paths.append(fp)

    try:
        import imageio.v2 as imageio

        frames = [imageio.imread(p)[..., :3] / 255.0 for p in frame_paths]
        # one common, even size: bbox_inches="tight" can vary by a few
        # pixels between frames
        H = max(f.shape[0] for f in frames)
        W = max(f.shape[1] for f in frames)
        H += H % 2
        W += W % 2
        frames = [np.pad(f, ((0, H - f.shape[0]), (0, W - f.shape[1]),
                             (0, 0)), constant_values=1.0) for f in frames]
    except Exception:
        return frame_dir
    return write_video(os.path.join(out_dir, "poses.mp4"), frames, fps=fps)
