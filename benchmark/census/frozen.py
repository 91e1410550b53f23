"""Frozen copies of the port's sound arithmetic, each named with the file
and commit it came from, so that a change to the program cannot move the
yardstick.  The originals stay in the program until a later change deletes
them.

- ``roofline_compacted``: joint_tensorf_tpu_torch/bench.py:567-608 at
  cccd099 (the compacted step's byte and float32 floors at the root
  bench's shapes).  Kept as it was; census/counts.py extends its census
  to every cell.
- ``warm_start_density``: chip_smoke.py:1228-1283 at cccd099, rewritten
  to act on the benchmark's weight tensors before they reach either side
  (the original edits a Trainer's field in place).
- ``device_detail``: joint_tensorf_tpu_torch/bench.py:611-634 at cccd099,
  the card branch alone (the benchmark never reports a CPU run).
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

# one H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit
H100_HBM_BYTES_PER_SEC = 3.35e12
H100_F32_FLOP_PER_SEC = 67e12

# chip_smoke.py:288-290 at cccd099
WARM_DENSITY = 2.0
WARM_RADII = 0.5

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def roofline_compacted(n, K, K2, n_samples, res_xyz, t_step, card) -> dict:
    """Analytic floors of the compacted step against one H100's published
    peaks: ``n`` rays, ``K`` kept slots, ``K2`` shaded ones, ranks 16 / 48,
    a res_xyz^3 grid (bench.py at cccd099, unchanged)."""
    Rd, Ra = 16, 48
    rows_gather = 3 * n * K + 3 * n * K2
    rows_probe = n * (n_samples // 4)
    rows_scatter = 3 * n * K + 3 * n * K2
    rows_total = rows_gather + rows_probe + rows_scatter
    row_bytes = (3 * n * K * (4 * Rd) * 4
                 + 3 * n * K2 * (4 * Ra) * 4) * 2
    params = 3 * res_xyz * res_xyz * (Rd + Ra) + 3 * res_xyz * (Rd + Ra)
    bytes_streamed = (params * 4 * 6 + 2 * params * 4
                      + n * n_samples * 4 * 6 + row_bytes)
    t_hbm_floor = bytes_streamed / H100_HBM_BYTES_PER_SEC
    flops = (2 * n * K2 * (150 * 64 + 64 * 64 + 64 * 3) * 3
             + 2 * n * K2 * (3 * Ra) * 27 * 3)
    t_f32 = flops / H100_F32_FLOP_PER_SEC
    measured = t_step is not None
    t_row = max(t_step - t_hbm_floor - t_f32, 0.0) if measured else None
    return {
        "streamed_bytes_per_step": bytes_streamed,
        "f32_flop_per_step": flops,
        "t_hbm_floor_ms": t_hbm_floor * 1e3,
        "t_f32_flop_floor_ms": t_f32 * 1e3,
        "hbm_util": (t_hbm_floor / t_step if measured else "not measured"),
        "rows_per_step": rows_total,
        "effective_ns_per_row": (t_row / rows_total * 1e9 if measured
                                 else "not measured"),
        "card": card,
    }


@torch.no_grad()
def warm_start_density(weights: dict, centers, radii, aabb, res,
                       warm_radii: float = WARM_RADII) -> list:
    """Raise density component k of every plane over the box of
    +-``warm_radii`` radii (chip_smoke's 0.5 by default) around object k's
    centre (over the plane's two axes) and of
    every line over the box's third axis, by 2.0: the density feature there
    clears the alpha threshold, elsewhere it keeps its drawn value, so the
    mask updates find the scene's objects and rays cross empty space
    between them.  ``weights``: {"density_planes.i": [H, W, R],
    "density_lines.i": [D, R], ...} at resolution ``res`` over ``aabb``
    [2, 3]; edited in place.  Returns the boxes."""
    axes = [np.linspace(aabb[0][a], aabb[1][a], res[a]) for a in range(3)]
    boxes = []
    dev = weights["density_lines.0"].device
    for k, (c, r) in enumerate(zip(centers, radii)):
        lo, hi = c - warm_radii * r, c + warm_radii * r
        inside = [torch.as_tensor((x >= lo[a]) & (x <= hi[a]),
                                  dtype=torch.float32, device=dev)
                  for a, x in enumerate(axes)]
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            weights[f"density_planes.{i}"][..., k].add_(
                WARM_DENSITY * inside[m1][:, None] * inside[m0][None, :])
            weights[f"density_lines.{i}"][:, k].add_(
                WARM_DENSITY * inside[VEC_MODE[i]])
        boxes.append([lo.tolist(), hi.tolist()])
    return boxes


def device_detail(index: int = 0) -> dict:
    """The card the numbers came from: its name, the device count and
    nvidia-smi's name and power limit."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"nvidia-smi not read: {e}"]
    return {"device": torch.cuda.get_device_name(index),
            "device_count": torch.cuda.device_count(),
            "nvidia_smi": smi[index] if len(smi) > index else None}
