"""Float32 operations and HBM bytes of one BAT training step, counted from
the cell's shapes and the samples its inputs need, never from the
program's budgets (compaction K, app_k) or its launches.

The samples a step needs are counted by the reference (reference/step.py):
``n_valid``, the samples in the box and the alpha mask, whose density the
step must evaluate and differentiate; ``n_gated``, those whose weight
passes the ray-march threshold, whose appearance it must shade.  A step
that evaluates more (padding slots, a dense grid) spends more than the
floor; one that evaluated fewer would compute another function.

Counting rules (the extended census of census/frozen.roofline_compacted):
each input byte is read once and each output byte written once: the
parameters and both Adam moments read and written (24 bytes a float32
parameter), the targets and edge weights of the rays read; per-sample
intermediates stay on chip.  Operations, forward + backward = 3 x the
forward: per sample and axis a bilinear plane (8R), a linear line (4R),
product and sum (2R); the appearance basis (2 x 3Ra x app_dim) and the
shading MLP (2 x fan_in x fan_out a layer); compositing (10 a sample);
the factor blur as a separable 1-D convolution of ``taps`` (2 x taps a
factor element and axis, forward and its transpose); Adam (12 a
parameter).
"""
from __future__ import annotations

import dataclasses

from .frozen import H100_F32_FLOP_PER_SEC, H100_HBM_BYTES_PER_SEC


@dataclasses.dataclass(frozen=True)
class StepShape:
    n_rays: int
    n_valid: float                  # density samples a step needs
    n_gated: float                  # shaded samples a step needs
    density_ranks: tuple            # R_d of the three axes
    app_ranks: tuple                # R_a of the three axes
    app_dim: int
    head_layers: tuple              # ((fan_in, fan_out), ...)
    planes: tuple                   # (H, W) of the three planes
    lines: tuple                    # D of the three lines
    n_params: int                   # field + pose parameters
    blur_taps: tuple = ()           # (density taps, colour taps) or ()


def step_flops(s: StepShape) -> float:
    density = sum(14 * r for r in s.density_ranks)
    app = (sum(14 * r for r in s.app_ranks)
           + 2 * sum(s.app_ranks) * s.app_dim
           + sum(2 * i * o for i, o in s.head_layers))
    per_step = 3 * (s.n_valid * (density + 10) + s.n_gated * app)
    if s.blur_taps:
        for taps, ranks in zip(s.blur_taps, (s.density_ranks, s.app_ranks)):
            elems = sum(2 * h * w * r + d * r for (h, w), d, r in
                        zip(s.planes, s.lines, ranks))
            per_step += 2 * 2 * taps * elems
    return per_step + 12 * s.n_params


def step_bytes(s: StepShape) -> float:
    return 24 * s.n_params + s.n_rays * (3 + 1) * 4


def step_floor_s(s: StepShape) -> float:
    """The least time one H100 could take for the step: the larger of the
    float32 operations over 67 TFLOP/s and the bytes over 3.35 TB/s."""
    return max(step_flops(s) / H100_F32_FLOP_PER_SEC,
               step_bytes(s) / H100_HBM_BYTES_PER_SEC)


def k3_floor_s(s: StepShape, dense_grid: bool) -> float:
    """The least time K3 (the row scatter of the factor gradients) could
    take a step: every gradient row the needed samples make read once,
    with a 4-byte index a row.  Bilinear plane samples make 4 corner rows
    of R, linear line samples 2 of R, dense-grid samples (``dense_grid``:
    the density read from the rank-expanded grid) 8 corner values."""
    if dense_grid:
        rows, floats = s.n_valid, 8 * s.n_valid
    else:
        rows = 2 * 3 * s.n_valid
        floats = s.n_valid * sum(6 * r for r in s.density_ranks)
    rows += 2 * 3 * s.n_gated
    floats += s.n_gated * sum(6 * r for r in s.app_ranks)
    return (4 * floats + 4 * rows) / H100_HBM_BYTES_PER_SEC
