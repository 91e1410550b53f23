"""Process-level PyTorch configuration: device choice and precision.

Counterpart of joint_tensorf_tpu/utils/jax_setup.py.  The reference pins
float32 matmuls ("highest" precision) because lower-precision 3x3 pose
products quantize ray directions by ~1e-3 and silently corrupt joint pose
optimisation.  On the GPU the same hazard is TF32: cuBLAS and cuDNN may
round float32 operands to 10-bit mantissas.  Both are turned off here, once,
and everything in the port stays float32.
"""
from __future__ import annotations

import torch


def setup_torch():
    """f32 everywhere: no TF32 in matmuls (pose products, blur matrices,
    the shading MLP) nor in convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  There is no fallback: asking for CUDA on a machine
    without it raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: CUDA was requested but this host has no CUDA "
            f"card (torch.cuda.is_available() is False); pass device='cpu' "
            f"to run the plain PyTorch path on the host")
    return dev
