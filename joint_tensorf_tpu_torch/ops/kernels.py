"""1D blur-kernel generators for the coarse-to-fine schedules
(counterpart of joint_tensorf_tpu/ops/kernels.py).

A requested ``kernel_size`` of K yields K//2*2+1 taps (65 for K=64, 201 for
K=201).  ``t`` may be a Python float or a 0-d tensor.  The per-component
and the exact discrete Gaussians (no entry point calls them, in either
package) are here too; the discrete one is computed on the host with
scipy, as JAX computes it.
"""
from __future__ import annotations

import math

import torch


def num_taps(kernel_size: int) -> int:
    return (kernel_size // 2) * 2 + 1


def _scalar(t, device):
    """``t`` as a 0-d float32 tensor; a host number is filled on the device
    (a copy from the host would synchronise it)."""
    if torch.is_tensor(t):
        return t.to(dtype=torch.float32, device=device)
    return torch.full((), float(t), dtype=torch.float32, device=device)


def gaussian_kernel(t, kernel_size: int, device=None):
    """[num_taps] sampled Gaussian; impulse at t=0 (sigma clamped at 1e-4,
    values clamped at 1.0)."""
    t = torch.clamp(_scalar(t, device), min=1e-4)
    ns = torch.arange(-(kernel_size // 2), kernel_size // 2 + 1,
                      dtype=torch.float32, device=t.device)
    exponent = -0.5 * (ns / t) ** 2
    kernel = 1.0 / (t * math.sqrt(2 * math.pi)) * torch.exp(exponent)
    return torch.clamp(kernel, max=1.0)


def average_kernel(t, kernel_size: int, device=None):
    """[num_taps] linearly-interpolated box kernel; impulse at t=0."""
    if kernel_size % 2 == 0:
        kernel_size += 1
    half = kernel_size // 2
    t = _scalar(t, device)
    ns = torch.abs(torch.arange(-half, half + 1, dtype=torch.float32,
                                device=t.device))
    t0 = torch.clamp(torch.floor(t), max=half)
    t1 = torch.clamp(torch.ceil(t), max=half)
    k0 = (ns <= t0) / (t0 * 2 + 1)
    k1 = (ns <= t1) / (t1 * 2 + 1)
    frac = torch.remainder(t, 1.0)
    return frac * k1 + (1 - frac) * k0


def batch_gaussian_kernel(sigmas, kernel_size: int, device=None):
    """Per-component kernels: sigmas [C] -> [C, num_taps] (each sampled as
    gaussian_kernel)."""
    sig = torch.as_tensor(sigmas, dtype=torch.float32, device=device)
    sig = torch.clamp(sig, min=1e-4)[:, None]
    ns = torch.arange(-(kernel_size // 2), kernel_size // 2 + 1,
                      dtype=torch.float32, device=sig.device)[None, :]
    kernel = 1.0 / (sig * math.sqrt(2 * math.pi)) * torch.exp(
        -0.5 * (ns / sig) ** 2)
    return torch.clamp(kernel, max=1.0)


def discrete_gaussian_kernel(t, kernel_size: int, device=None):
    """The exact discrete Gaussian T(n, t) = exp(-t) I_n(t) on the host
    (scipy's exponentially scaled ive, so a large t does not overflow);
    an impulse at t = 0.  ``kernel_size`` must be odd."""
    if kernel_size <= 0 or kernel_size % 2 != 1:
        raise ValueError(f"discrete_gaussian_kernel needs odd kernel_size, "
                         f"got {kernel_size}")
    import numpy as np
    from scipy import special

    ns = np.arange(-(kernel_size // 2), kernel_size // 2 + 1)
    return torch.as_tensor(special.ive(ns, float(t)), dtype=torch.float32,
                           device=device)
