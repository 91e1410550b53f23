"""Row scatter-add with a block-local accumulator: kernel K5 and its plain
version (counterpart of joint_tensorf_tpu/ops/tile_scatter.py).

    scatter_add_rows_tiled(idx, updates, n_rows)
        == zeros([n_rows, C]).at[idx].add(updates)

K3's contract (ops/segment_scatter.py) with the JAX package's other
design: sort the samples by destination, then let each block own BR
destination rows in shared memory and flush them once.  On a CUDA tensor
the wrapper sorts, permutes and searchsorts in PyTorch (as the JAX wrapper
does outside its kernel) and launches csrc/tile_scatter.cu; on a CPU
tensor it takes the plain version, ``index_add_``.  There is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_SMEM_FLOATS = 24576            # 96 KB of shared memory per block
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]


def block_rows(C: int) -> int:
    """Destination rows per block: BR x C float32 within 96 KB, at most 256."""
    return max(1, min(256, _SMEM_FLOATS // max(C, 1)))


def scatter_add_rows_tiled_plain(idx, updates, n_rows: int):
    """The plain PyTorch version (any device)."""
    out = torch.zeros((n_rows, updates.shape[-1]), dtype=updates.dtype,
                      device=updates.device)
    return out.index_add_(0, idx, updates)


def scatter_add_rows_tiled_cuda(idx, updates, n_rows: int):
    """Launch K5: idx [N] integer, updates [N, C] float32, on one CUDA
    device -> [n_rows, C] float32."""
    if not (idx.is_cuda and updates.is_cuda and idx.device == updates.device):
        raise ValueError("scatter_add_rows_tiled_cuda: idx and updates must "
                         "be on one CUDA device")
    if idx.dtype not in (torch.int32, torch.int64) or \
            updates.dtype != torch.float32:
        raise TypeError(f"scatter_add_rows_tiled_cuda: want integer idx and "
                        f"float32 updates, got {idx.dtype} and "
                        f"{updates.dtype}")
    if idx.dim() != 1 or updates.dim() != 2 or \
            updates.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_add_rows_tiled_cuda: bad shapes "
                         f"{tuple(idx.shape)} / {tuple(updates.shape)}")
    N, C = updates.shape
    if block_rows(C) * C * 4 > 232448:
        raise ValueError(f"scatter_add_rows_tiled_cuda: C={C} does not fit "
                         f"one row in shared memory")
    if N == 0 or n_rows == 0:
        return torch.zeros((n_rows, C), dtype=torch.float32,
                           device=updates.device)
    return launch_tiled(*sort_by_block(idx, updates, n_rows), n_rows)


def sort_by_block(idx, updates, n_rows: int):
    """(idx sorted, updates in that order, starts [n_blocks + 1]: each
    BR-row destination block's range of the sorted samples)."""
    BR = block_rows(updates.shape[1])
    idx_s, order = torch.sort(idx.to(torch.int64))
    upd_s = updates.index_select(0, order).contiguous()
    edges = torch.arange(-(-n_rows // BR) + 1, device=idx.device,
                         dtype=torch.int64) * BR
    return idx_s, upd_s, torch.searchsorted(idx_s, edges)


def launch_tiled(idx_s, upd_s, starts, n_rows: int):
    """Launch K5 on sorted samples (sort_by_block) -> [n_rows, C]."""
    C = upd_s.shape[1]
    out = torch.empty((n_rows, C), dtype=torch.float32, device=upd_s.device)
    fn = cuda_build.kernel("scatter_add_rows_tiled", _ARGTYPES)
    with torch.cuda.device(upd_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx_s.data_ptr(), upd_s.data_ptr(), starts.data_ptr(),
                 out.data_ptr(), C, n_rows, block_rows(C), stream)
    cuda_build.LAUNCHES["scatter_add_rows_tiled"] += 1
    cuda_build.check(err, "scatter_add_rows_tiled")
    return out


def scatter_add_rows_tiled(idx, updates, n_rows: int):
    """K5 on a CUDA tensor, the plain version on a CPU tensor."""
    if updates.is_cuda:
        return scatter_add_rows_tiled_cuda(idx, updates, n_rows)
    if updates.device.type != "cpu":
        raise ValueError(f"scatter_add_rows_tiled: no kernel for "
                         f"{updates.device}")
    return scatter_add_rows_tiled_plain(idx, updates, n_rows)
