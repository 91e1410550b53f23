"""Video assembly from rendered frames, on the host
(counterpart of joint_tensorf_tpu/viz/video.py).

Three outcomes, as the JAX package has them: the video itself when
imageio's writer works (its ffmpeg backend installed); else the frames as
``<stem>_frames/NNNN.png`` when imageio imports; else, without imageio,
``<stem>_frames/frames.npz`` (compressed, one uint8 array a frame).
"""
from __future__ import annotations

import os

import numpy as np


def write_video(path: str, frames, fps: int = 30) -> str:
    """frames: iterable of [H, W, 3] float arrays in [0, 1].  Returns the
    path written: ``path``, or the frame directory."""
    frames = [np.clip(np.asarray(f), 0, 1) for f in frames]
    frames8 = [(f * 255).astype(np.uint8) for f in frames]
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames8, fps=fps)
        return path
    except Exception:   # no imageio, or no video backend for it
        out_dir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(out_dir, exist_ok=True)
        try:
            import imageio.v2 as imageio

            for i, f in enumerate(frames8):
                imageio.imwrite(os.path.join(out_dir, f"{i:04d}.png"), f)
        except Exception:
            np.savez_compressed(os.path.join(out_dir, "frames.npz"),
                                *frames8)
        return out_dir


def depth_to_inv_vis(depth, opacity, eps: float = 1e-10):
    """Inverse depth (depth over opacity) stretched between its 1st and
    99th percentiles to [0, 1] (reference nerf.py:308)."""
    inv = 1.0 / (np.asarray(depth) / np.clip(np.asarray(opacity), eps, None)
                 + eps)
    lo, hi = np.percentile(inv, 1), np.percentile(inv, 99)
    return np.clip((inv - lo) / max(hi - lo, eps), 0, 1)
