"""Row scatter-add: kernel K3 and its plain version
(counterpart of joint_tensorf_tpu/ops/segment_scatter.py).

    scatter_add_rows(idx, updates, n_rows) == zeros([n_rows, C]).at[idx].add(updates)

The factor planes' gradient in sample_planeline_prod's backward is one such
scatter per plane (ops/sampling.py), and the dense grid's gradient another
(ops/densify.py).  On a CUDA tensor the wrapper launches the hand-written
kernel (csrc/segment_scatter.cu, whose C entry point picks its route from
C: one row a thread up to 16 channels, groups of C/4 threads beyond; one
counted launch either way, its shape noted in cuda_build.SCATTER_SHAPES);
on a CPU tensor it takes the plain version, ``index_add_``.  There is no
other path.  Indices outside [0, n_rows) are dropped by the kernel;
``index_add_`` refuses them.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]


def scatter_add_rows_plain(idx, updates, n_rows: int):
    """The plain PyTorch version (any device)."""
    out = torch.zeros((n_rows, updates.shape[-1]), dtype=updates.dtype,
                      device=updates.device)
    return out.index_add_(0, idx, updates)


def scatter_add_rows_cuda(idx, updates, n_rows: int):
    """Launch K3: idx [N] int64, updates [N, C] float32, both contiguous on
    one CUDA device -> [n_rows, C] float32.

    The dense grid's call is short on the card (~0.01 ms at 448k x 8), so
    the host's work per call sets its pace: the output is allocated here
    and zeroed by the C entry point (a memset on the stream, not a torch
    fill), device indices are compared as ints, the stream is read raw, and
    the device is switched only when it is not the current one."""
    dev = updates.get_device()
    if not (idx.is_cuda and updates.is_cuda and idx.get_device() == dev):
        raise ValueError("scatter_add_rows_cuda: idx and updates must be on "
                         "one CUDA device")
    if idx.dtype != torch.int64 or updates.dtype != torch.float32:
        raise TypeError(f"scatter_add_rows_cuda: want int64 idx and float32 "
                        f"updates, got {idx.dtype} and {updates.dtype}")
    if idx.dim() != 1 or updates.dim() != 2 or \
            updates.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_add_rows_cuda: bad shapes "
                         f"{tuple(idx.shape)} / {tuple(updates.shape)}")
    if not (idx.is_contiguous() and updates.is_contiguous()):
        raise ValueError("scatter_add_rows_cuda: inputs must be contiguous")
    N, C = updates.shape
    out = torch.empty((n_rows, C), dtype=torch.float32, device=updates.device)
    fn = cuda_build.kernel("segment_scatter", "scatter_add_rows",
                           _ARGTYPES)
    args = (idx.data_ptr(), updates.data_ptr(), out.data_ptr(), N, C, n_rows)
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    cuda_build.LAUNCHES["scatter_add_rows"] += 1
    shape = cuda_build.SCATTER_SHAPES
    shape[C, n_rows] = max(N, shape.get((C, n_rows), 0))
    cuda_build.check(err, "scatter_add_rows")
    return out


def scatter_add_rows(idx, updates, n_rows: int):
    """K3 on a CUDA tensor, the plain version on a CPU tensor."""
    if updates.is_cuda:
        return scatter_add_rows_cuda(idx, updates, n_rows)
    if updates.device.type != "cpu":
        raise ValueError(f"scatter_add_rows: no kernel for {updates.device}")
    return scatter_add_rows_plain(idx, updates, n_rows)
