"""Row scatter-add with a block-local accumulator: kernel K5 and its plain
version (counterpart of joint_tensorf_tpu/ops/tile_scatter.py).

    scatter_add_rows_tiled(idx, updates, n_rows)
        == zeros([n_rows, C]).at[idx].add(updates)

K3's contract (ops/segment_scatter.py) with the JAX package's other
design: each block owns BR destination rows in shared memory and flushes
them once.  On a CUDA tensor the wrapper launches csrc/tile_scatter.cu
twice: ``bucket_by_block`` (count, scan and fill kernels: the samples
bucketed by destination block, by position, without sorting and without
moving an update row) and ``accumulate`` (K5 proper, one block per chunk of
at most CHUNK samples of one bucket).  The route allocates the bucketing's
arrays with ``torch.empty``; it sizes them and the grid from N, n_rows and
C alone, so it never waits on the host.  On a CPU tensor the wrapper
takes the plain version, ``index_add_``.  There is no other path.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build

_SMEM_FLOATS = 24576            # 96 KB of shared memory per block
CHUNK = 2048                    # samples per accumulate block, at most
_P = ctypes.c_void_p
_BUCKET_ARGTYPES = [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P]
_ACC_ARGTYPES = [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]


def block_rows(C: int) -> int:
    """Destination rows per block: BR x C float32 within 96 KB, at most 256."""
    return max(1, min(256, _SMEM_FLOATS // max(C, 1)))


class Plan(NamedTuple):
    """Sizes of one bucketing: BR rows per bucket, n_buckets and n_map
    accumulate blocks (ceil(N / CHUNK) + n_buckets bounds the chunks, since
    each bucket has max(1, ceil(count / CHUNK)) of them)."""
    BR: int
    n_buckets: int
    n_map: int


def plan(N: int, n_rows: int, C: int) -> Plan:
    BR = block_rows(C)
    n_buckets = -(-n_rows // BR)
    return Plan(BR, n_buckets, -(-N // CHUNK) + n_buckets)


class Bucketing(NamedTuple):
    """The samples bucketed by destination block, int32 arrays that
    bucket_by_block fills (csrc/tile_scatter.cu, Layout)."""
    perm: torch.Tensor          # [N, 2]: (position, row within its block)
    counts: torch.Tensor        # [n_buckets]: samples per bucket
    offset: torch.Tensor        # [n_buckets + 1]: exclusive prefix of counts
    cursor: torch.Tensor        # [n_buckets]: the fill's claims
    chunk_start: torch.Tensor   # [n_buckets + 1]: exclusive prefix of chunks
    chunk_bucket: torch.Tensor  # [n_map]: each accumulate block's bucket or -1


def empty_bucketing(N: int, p: Plan, device) -> Bucketing:
    nb = p.n_buckets
    return Bucketing(*(torch.empty(shape, dtype=torch.int32, device=device)
                       for shape in ((N, 2), (nb,), (nb + 1,), (nb,),
                                     (nb + 1,), (p.n_map,))))


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
    if N == 0 or n_rows == 0 or C == 0:
        return torch.zeros((n_rows, C), dtype=torch.float32,
                           device=updates.device)
    if max(N, plan(N, n_rows, C).n_map) >= 2 ** 31:
        raise ValueError(f"scatter_add_rows_tiled_cuda: N={N} samples "
                         f"exceed the kernels' int32 positions")
    return accumulate(updates.contiguous(),
                      *bucket_by_block(idx.contiguous(), n_rows, C), n_rows)


def bucket_by_block(idx, n_rows: int, C: int):
    """Bucket the samples by destination block of block_rows(C) rows
    (csrc/tile_scatter.cu passes 1-3) -> (Bucketing, out): the output
    [n_rows, C] is uninitialised except for the rows of buckets above
    CHUNK samples, which are zeroed."""
    N = idx.shape[0]
    p = plan(N, n_rows, C)
    bk = empty_bucketing(N, p, idx.device)
    out = torch.empty((n_rows, C), dtype=torch.float32, device=idx.device)
    fn = cuda_build.kernel("tile_scatter", "tile_bucket", _BUCKET_ARGTYPES)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx.data_ptr(), idx.element_size(), N, n_rows, p.BR, CHUNK,
                 p.n_buckets, p.n_map, *(t.data_ptr() for t in bk),
                 out.data_ptr(), C, stream)
    cuda_build.check(err, "tile_bucket")
    return bk, out


def accumulate(updates, bk: Bucketing, out, n_rows: int):
    """Launch K5 proper on a bucketing (bucket_by_block) of updates' rows
    -> out [n_rows, C]."""
    N, C = updates.shape
    p = plan(N, n_rows, C)
    fn = cuda_build.kernel("tile_scatter", "scatter_add_rows_tiled",
                           _ACC_ARGTYPES)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(updates.data_ptr(), bk.perm.data_ptr(), bk.offset.data_ptr(),
                 bk.chunk_start.data_ptr(), bk.chunk_bucket.data_ptr(),
                 out.data_ptr(), C, n_rows, p.BR, CHUNK, p.n_map, stream)
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
