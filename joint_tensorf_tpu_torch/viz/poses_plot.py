"""Camera pose plots with matplotlib, on the host
(counterpart of joint_tensorf_tpu/viz/poses_plot.py; reference
util_vis.py:236-307): camera frustum wireframes of predicted (aligned)
against ground-truth poses, and the per-view error scatter.

matplotlib is imported inside the functions: where it is missing, the
ImportError reaches the caller (evaluate prints that the plot is
skipped, as the JAX package's does).
"""
from __future__ import annotations

import numpy as np


def _camera_frustum(pose, depth: float = 0.5):
    """Wireframe vertices of a camera frustum in world space.

    pose: [3,4] world->cam (numpy).  Returns [5, 3]: the centre, then the
    four corners of the image plane at ``depth``."""
    R, t = pose[:, :3], pose[:, 3]
    center = -R.T @ t
    corners_cam = np.array([
        [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.5, 0.5, 1.0], [-0.5, 0.5, 1.0],
    ]) * depth
    corners = (corners_cam @ R) + center
    return np.concatenate([center[None], corners])


def _as_numpy(poses):
    return (poses.detach().cpu().numpy() if hasattr(poses, "detach")
            else np.asarray(poses))


def plot_poses_3d(path: str, poses, poses_ref=None, depth: float = 0.5,
                  title: str = ""):
    """Save a 3D plot of ``poses`` [V, 3, 4] (blue) against ``poses_ref``
    (red, dashed) to ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_title(title)

    def draw(pose_set, color, ls="-"):
        for p in _as_numpy(pose_set):
            v = _camera_frustum(p, depth)
            for j in range(1, 5):
                ax.plot(*zip(v[0], v[j]), color=color, lw=0.6, ls=ls)
            ring = [1, 2, 3, 4, 1]
            ax.plot(v[ring, 0], v[ring, 1], v[ring, 2], color=color, lw=0.6,
                    ls=ls)

    if poses_ref is not None:
        draw(poses_ref, "red", ls="--")
    draw(poses, "blue")
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(path, dpi=75, bbox_inches="tight")
    plt.close(fig)


def plot_pose_error_scatter(path: str, mse_values, rot_errors, trans_errors,
                            it: int):
    """Per-view MSE against rotation and translation error, two panels
    (reference bat.py:142-188)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(16, 8))
    ax1 = fig.add_subplot(121)
    ax2 = fig.add_subplot(122)
    ax1.set_title(f"train MSE-error_R, iters={it}")
    ax2.set_title(f"train MSE-error_t, iters={it}")
    ax1.scatter(mse_values, rot_errors)
    ax2.scatter(mse_values, trans_errors)
    ax1.set_xlabel("mse")
    ax1.set_ylabel("error_R")
    ax2.set_xlabel("mse")
    ax2.set_ylabel("error_t")
    fig.savefig(path, dpi=75)
    plt.close(fig)
