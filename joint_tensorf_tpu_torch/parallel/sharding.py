"""The ray split and the collectives of a data-parallel step
(counterpart of joint_tensorf_tpu/parallel/sharding.py, rays layout).

JAX slices the step's rays with ``P("rays")`` and the pre-drawn jitter
with ``P(None, "rays")`` inside a shard_map, and pmeans loss, metrics and
gradients (sharding.py:84-135 of the JAX package).  Here every rank keeps
all of ``view_sel`` and a contiguous block of the per-view rays
(ray_block), renders it, and the gradients meet in one flat bucket reduced
by one ``all_reduce(SUM)`` (reduce_bucket).  Besides it:

* gather_rays, an autograd-aware gather over the rays axis (depth TV, the
  L2G error map, evaluation chunks), written as a zero-padded all_reduce
  so that every backend runs it (gloo on CUDA tensors included).  Its
  backward slices this rank's block out of the cotangent without a
  collective: a caller computes the gathered term identically on every
  rank, so each rank's cotangent is the whole term's;
* reduce_counts, the one all-reduce of the loss's non-NaN counts, which a
  sum/count loss needs before the backward (train/losses.py);
* broadcast_ints, rank 0's integers (the compaction budgets) to every rank;
* verify_replicas, a checksum of the bits of every given tensor on every
  rank: raises when the replicas differ;
* render_sharded, the counterpart of shard_render_chunk: each rank renders
  its block of an evaluation chunk and the blocks are gathered.

Every collective adds one to ``mesh.counts[purpose]``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh


def _count(mesh: Mesh, purpose: str):
    mesh.counts[purpose] = mesh.counts.get(purpose, 0) + 1


def _all_reduce(mesh: Mesh, t, purpose: str, op=dist.ReduceOp.SUM):
    _count(mesh, purpose)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def ray_block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` per-view rays (JAX's
    ``P("rays")``); ``n`` must divide by the rays axis."""
    d = mesh.rays
    if n % d:
        raise ValueError(f"rays per view ({n}) must be divisible by the mesh "
                         f"rays axis ({d}) -- adjust nerf.n_rays / "
                         f"train_schedule.n_rays_*")
    b = n // d
    r = mesh.rank % d
    return slice(r * b, (r + 1) * b)


def shard_rays(mesh: Mesh, x, n_views: int, n_rays: int):
    """This rank's block of per-ray values ``x`` [Vs*R, ...], flat in view
    order (the jitter): reshaped to [Vs, R, ...] and sliced on axis 1, as
    JAX's ``P(None, "rays")``, then flat again.  Values indexed [..., R]
    per view take ``x[..., ray_block(mesh, R)]``."""
    blk = ray_block(mesh, n_rays)
    rest = x.shape[1:]
    return x.reshape(n_views, n_rays, *rest)[:, blk].reshape(-1, *rest)


class _GatherRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        d, r = mesh.rays, mesh.rank % mesh.rays
        buf = x.new_zeros((x.shape[0], d) + tuple(x.shape[1:]))
        buf[:, r] = x
        _all_reduce(mesh, buf, "gather")
        return buf.reshape(x.shape[0], d * x.shape[1], *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        d, r = mesh.rays, mesh.rank % mesh.rays
        g = g.reshape(g.shape[0], d, g.shape[1] // d, *g.shape[2:])
        return g[:, r], None


def gather_rays(mesh: Mesh, x):
    """[B, r, ...] blocks of every rank -> [B, D*r, ...] in the unsharded
    ray order.  The backward hands this rank its block of the cotangent;
    the gathered value must enter the loss identically on every rank."""
    return _GatherRays.apply(x, mesh)


def reduce_counts(mesh: Mesh, counts):
    """The global non-NaN counts of a sum/count loss (a small integer
    tensor), reduced once before the backward."""
    return _all_reduce(mesh, counts.clone(), "nan_counts")


def reduce_bucket(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> list:
    """Sum ``tensors`` (gradients, then scalar numerators) over the ranks
    in ONE all_reduce of one flat float32 buffer; returns them in their
    own shapes and dtypes."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    _all_reduce(mesh, flat, "grads")
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(t.shape).to(t.dtype))
        at += n
    return out


def bucket_bytes(tensors: Sequence[torch.Tensor]) -> int:
    return 4 * sum(t.numel() for t in tensors)


def broadcast_ints(mesh: Mesh, values: Sequence[Optional[int]]) -> list:
    """Rank 0's integers (None travels as -1) on every rank."""
    t = torch.tensor([-1 if v is None else int(v) for v in values],
                     dtype=torch.int64, device=mesh.device)
    _count(mesh, "broadcast")
    dist.broadcast(t, src=0, group=mesh.group)
    return [None if v < 0 else v for v in t.tolist()]


def bits_sum(t) -> torch.Tensor:
    """The sum of a tensor's bit patterns as int64 (exact)."""
    t = t.detach().contiguous()
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    return t.view(view).to(torch.int64).sum()


def verify_replicas(mesh: Mesh, tensors: dict, what: str):
    """Raise when the named tensors differ in a bit between ranks: one
    all_reduce of the per-tensor checksums and their negatives under MAX
    (max == -max(-x) on every tensor iff all ranks agree)."""
    names = sorted(tensors)
    sums = torch.stack([bits_sum(tensors[k]).to(mesh.device)
                        for k in names])
    both = torch.cat([sums, -sums])
    _all_reduce(mesh, both, "checksum", op=dist.ReduceOp.MAX)
    n = len(names)
    bad = [k for k, hi, lo in zip(names, both[:n].tolist(),
                                  both[n:].tolist()) if hi != -lo]
    if bad:
        raise RuntimeError(f"replicas differ after {what}: {bad}")


def barrier(mesh: Mesh):
    _count(mesh, "barrier")
    dist.barrier(group=mesh.group)


def render_sharded(mesh: Mesh, render, centers, dirs):
    """render(centers, dirs) -> (rgb [n, 3], depth [n], opacity [n]) on
    this rank's block of the chunk, the blocks gathered: the counterpart
    of shard_render_chunk.  A chunk that does not divide by the rays axis
    is padded with copies of its last ray, which are dropped again."""
    n = centers.shape[0]
    d = mesh.rays
    pad = -n % d
    if pad:
        centers = torch.cat([centers, centers[-1:].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)])
    blk = ray_block(mesh, n + pad)
    rgb, depth, opacity = render(centers[blk], dirs[blk])
    out = torch.cat([rgb, depth[:, None], opacity[:, None]], dim=1)
    out = gather_rays(mesh, out[None])[0][:n]
    return out[:, :3], out[:, 3], out[:, 4]
