"""Dense alpha-grid mask for empty-space culling
(counterpart of joint_tensorf_tpu/models/alpha_mask.py).

The mask is a {0, 1} float grid stored [X, Y, Z] with its own box, sampled
trilinearly; the renderer keeps a sample where the sampled value is > 0.
The JAX package looks the mask up through a uint8 2x2x2-neighbourhood
layout chosen for the TPU's row gathers; the port uses the plain trilinear
form (ops/sampling.sample_grid3d), whose gate ``a > 0`` is the same: every
term of both sums is a non-negative product of the same clamped weights.

The refresh runs at scheduled iterations, outside the train step: evaluate
density on a dense grid, max-pool (kernel 5), threshold, and propose a
tightened box.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.sampling import sample_grid3d
from . import vm as vm_lib


@dataclasses.dataclass
class AlphaMask:
    grid: torch.Tensor       # [X, Y, Z] float 0/1
    aabb: torch.Tensor       # [2, 3]


def sample_alpha(mask: AlphaMask, xyz):
    """World coords, a (x, y, z) tuple of [N] tensors -> trilinear mask
    values [N] (the reference's tensorBase.py:91-95)."""
    a = mask.aabb
    n = [(w - a[0, i]) * (2.0 / (a[1, i] - a[0, i])) - 1.0
         for i, w in enumerate(xyz)]
    return sample_grid3d(mask.grid, *n)


@torch.no_grad()
def dense_alpha(field: vm_lib.VMField, cfg: vm_lib.VMConfig, grid_size,
                step_size: float, chunk: int = 128 * 1024):
    """Opacity 1 - exp(-sigma * step) on a dense grid spanning the field's
    box (the reference's tensorBase.py:618-634), evaluated in chunks of
    ``chunk`` points.  Returns (alpha [X, Y, Z], xyz [X, Y, Z, 3])."""
    dev = field.aabb.device
    axes = []
    for g in (int(s) for s in grid_size):
        # jnp.linspace(0, 1, g) as XLA computes it in float32: i times the
        # rounded reciprocal 1 / (g - 1), so both grids hold the same points
        t = torch.arange(g, dtype=torch.float32, device=dev)
        axes.append(t * (1.0 / (g - 1)) if g > 1 else t)
    samples = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    samples = samples.reshape(-1, 3)
    aabb = field.aabb
    xyz = aabb[0] * (1 - samples) + aabb[1] * samples
    alpha = torch.empty(xyz.shape[0], dtype=torch.float32, device=dev)
    for s in range(0, xyz.shape[0], chunk):
        pts = xyz[s:s + chunk]
        coords = tuple(vm_lib.normalize_coord(pts[:, a], aabb[:, a])
                       for a in range(3))
        sigma = vm_lib.feature2density(
            cfg, vm_lib.compute_density_feature(field, coords))
        alpha[s:s + chunk] = 1.0 - torch.exp(-sigma * step_size)
    shape = [int(s) for s in grid_size]
    return alpha.reshape(shape), xyz.reshape(shape + [3])


def maxpool3d_same(x, k: int = 5):
    """Stride-1 'same' max pool over [X, Y, Z] (padding k // 2)."""
    return F.max_pool3d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def capped_mask_res(res, cap_voxels: int = 256 ** 3):
    """Mask-build resolution: ``res`` scaled down isotropically so the
    voxel count stays under ``cap_voxels`` (the JAX package builds a capped
    mask where the reference skips the update past 256^3)."""
    res = [int(r) for r in res]
    vol = res[0] * res[1] * res[2]
    if vol <= cap_voxels:
        return res
    scale = (cap_voxels / vol) ** (1.0 / 3.0)
    return [max(1, int(r * scale)) for r in res]


@torch.no_grad()
def update_alpha_mask(field: vm_lib.VMField, cfg: vm_lib.VMConfig, grid_size,
                      step_size: float, alpha_thresh: float):
    """Rebuild the mask (the reference's tensorBase.py:636-661).

    Returns (AlphaMask, proposed box [2, 3] float32 numpy): the box spans
    the grid points the mask keeps, or is the field's box if it keeps
    none."""
    alpha, xyz = dense_alpha(field, cfg, grid_size, step_size)
    pooled = maxpool3d_same(torch.clamp(alpha, 0, 1), 5)
    grid = (pooled >= alpha_thresh).to(torch.float32)
    mask = AlphaMask(grid=grid, aabb=field.aabb.clone())
    valid = xyz[grid > 0.5]
    if valid.shape[0] == 0:
        new_aabb = field.aabb.cpu().numpy()
    else:
        new_aabb = torch.stack([valid.amin(0), valid.amax(0)]).cpu().numpy()
    return mask, new_aabb
