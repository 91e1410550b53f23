"""Float32 operations and HBM bytes of one BARF training step (the
coordinate MLP of reference/barf.py), counted from the cell's shapes: the
rays and samples a step, the MLP's layers, the encodings' widths and the
parameters.  BARF shades every sample, so nothing depends on the inputs.

Counting rules, as census/counts.py's: each input byte is read once and
each output byte written once.
- The MLP's matrix products: a layer of fan-in i and fan-out o is three
  products a step, the forward (rows x i by i x o), the input's gradient
  (every layer's, the first one's too: the pose's gradient passes through
  the encoded points and views) and the weight's gradient, each 2 rows i o
  operations; each reads its two operands and writes its result once
  (4 bytes a float).
- The whole step: the products, and 3 x the forward of the rest a sample
  (the encodings' products and sines or cosines, 2 an encoded value;
  compositing, 10), Adam (12 a parameter); its bytes are the parameters
  and both of Adam's moments read and written (24 a parameter) and the
  rays' targets read, the per-sample intermediates staying on chip.
"""
from __future__ import annotations

import dataclasses

from .frozen import H100_F32_FLOP_PER_SEC, H100_HBM_BYTES_PER_SEC


@dataclasses.dataclass(frozen=True)
class StepShape:
    n_rays: int
    n_samples: int                  # samples a ray
    layers: tuple                   # ((fan_in, fan_out), ...) every layer
    encoded: int                    # encoded values a sample (points, view)
    n_params: int                   # MLP + pose parameters

    @property
    def rows(self) -> int:
        return self.n_rays * self.n_samples


def mlp_flops(s: StepShape) -> float:
    return 3 * 2 * s.rows * sum(i * o for i, o in s.layers)


def mlp_bytes(s: StepShape) -> float:
    return 3 * 4 * sum(s.rows * (i + o) + i * o for i, o in s.layers)


def mlp_floor_s(s: StepShape) -> float:
    """The least time one H100 could take for the MLP's matrix products,
    forward and backward: the larger of the float32 operations over 67
    TFLOP/s and the bytes over 3.35 TB/s."""
    return max(mlp_flops(s) / H100_F32_FLOP_PER_SEC,
               mlp_bytes(s) / H100_HBM_BYTES_PER_SEC)


def step_flops(s: StepShape) -> float:
    return (mlp_flops(s) + 3 * s.rows * (2 * s.encoded + 10)
            + 12 * s.n_params)


def step_bytes(s: StepShape) -> float:
    return 24 * s.n_params + s.n_rays * 3 * 4


def step_floor_s(s: StepShape) -> float:
    """The least time one H100 could take for the whole step, by the same
    two peaks."""
    return max(step_flops(s) / H100_F32_FLOP_PER_SEC,
               step_bytes(s) / H100_HBM_BYTES_PER_SEC)
