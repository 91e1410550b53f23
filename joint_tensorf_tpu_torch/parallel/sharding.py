"""The ray split, the component split and the collectives of a sharded
step (counterpart of joint_tensorf_tpu/parallel/sharding.py).

The rays layout.  JAX slices the step's rays with ``P("rays")`` and the
pre-drawn jitter with ``P(None, "rays")`` inside a shard_map, and pmeans
loss, metrics and gradients (sharding.py:84-135 of the JAX package).  Here
every rank keeps all of ``view_sel`` and a contiguous block of the
per-view rays (ray_block, by its rays index), renders it, and the
gradients meet in one flat bucket reduced by one ``all_reduce(SUM)`` over
the rays group (reduce_bucket).  Besides it:

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
  rank of a group: raises when the replicas differ;
* render_sharded, the counterpart of shard_render_chunk: each rank renders
  its block of an evaluation chunk and the blocks are gathered.

The comp layout.  JAX shards every plane with ``P(None, None, "comp")``
and every line with ``P(None, "comp")`` (sharding.py:33-70 of the JAX
package) and lets GSPMD insert the partial sums.  Here every rank holds
the contiguous block comp_block of each factor's components, and the
field's feature functions (models/vm.py) compute their partial sums on it
and meet in Megatron's conjugate pair (Shoeybi et al., 2019):

* copy_to_comp, identity forward and an all-reduce of the gradient over
  the comp group backward, on the sample coordinates that enter the
  factors: each rank's coordinate gradient holds its components' part;
* reduce_comp, an all-reduce over the comp group forward and identity
  backward, on the partial features: every rank then holds the whole
  feature, and everything after it (compositing, the head, the loss) is
  computed identically on every rank of a comp group;
* gather_comp, the components of every rank in their order (checkpoints,
  snapshots, comparisons), a zero-padded all_reduce of the bits.

Each collective names its axis (None: the world) and adds one to
``mesh.counts[purpose]`` (an all_reduce also its buffer's bytes to
``mesh.nbytes[purpose]``); over an axis of one rank in a larger world none
runs and none is counted.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import ALONE, Mesh


def _count(mesh: Mesh, purpose: str):
    mesh.counts[purpose] = mesh.counts.get(purpose, 0) + 1


def _all_reduce(mesh: Mesh, t, purpose: str, op=dist.ReduceOp.SUM,
                axis: Optional[str] = None):
    """All-reduce ``t`` in place over ``axis``'s group (None: the
    world)."""
    group = mesh.groups.get(axis) if axis else None
    if group is ALONE:
        return t
    _count(mesh, purpose)
    mesh.nbytes[purpose] = (mesh.nbytes.get(purpose, 0)
                            + t.numel() * t.element_size())
    dist.all_reduce(t, op=op, group=group)
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
    r = mesh.rays_index
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
        d, r = mesh.rays, mesh.rays_index
        buf = x.new_zeros((x.shape[0], d) + tuple(x.shape[1:]))
        buf[:, r] = x
        _all_reduce(mesh, buf, "gather", axis="rays")
        return buf.reshape(x.shape[0], d * x.shape[1], *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        d, r = mesh.rays, mesh.rays_index
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
    return _all_reduce(mesh, counts.clone(), "nan_counts", axis="rays")


def reduce_bucket(mesh: Mesh, tensors: Sequence[torch.Tensor],
                  axis: str = "rays", purpose: str = "grads") -> list:
    """Sum ``tensors`` (gradients, then scalar numerators) over ``axis``'s
    group in ONE all_reduce of one flat float32 buffer; returns them in
    their own shapes and dtypes."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    _all_reduce(mesh, flat, purpose, axis=axis)
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
    dist.broadcast(t, src=0)
    return [None if v < 0 else v for v in t.tolist()]


def bits_sum(t) -> torch.Tensor:
    """The sum of a tensor's bit patterns as int64 (exact)."""
    t = t.detach().contiguous()
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    return t.view(view).to(torch.int64).sum()


def verify_replicas(mesh: Mesh, tensors: dict, what: str,
                    axis: Optional[str] = None):
    """Raise when the named tensors differ in a bit between the ranks of
    ``axis``'s group (None: the world): one all_reduce of the per-tensor
    checksums and their negatives under MAX (max == -max(-x) on every
    tensor iff all ranks agree)."""
    names = sorted(tensors)
    sums = torch.stack([bits_sum(tensors[k]).to(mesh.device)
                        for k in names])
    both = torch.cat([sums, -sums])
    _all_reduce(mesh, both, "checksum", op=dist.ReduceOp.MAX, axis=axis)
    n = len(names)
    bad = [k for k, hi, lo in zip(names, both[:n].tolist(),
                                  both[n:].tolist()) if hi != -lo]
    if bad:
        where = f" of the {axis} group" if axis else ""
        raise RuntimeError(f"replicas{where} differ after {what}: {bad}")


def barrier(mesh: Mesh):
    _count(mesh, "barrier")
    dist.barrier()


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


# ------------------------------------------------------------ comp layout
def comp_block(n: int, mesh: Mesh, what: str = "components") -> slice:
    """This rank's contiguous block of ``n`` components (JAX's
    ``P(..., "comp")``); ``n`` must divide by the comp axis, as JAX's
    device_put requires."""
    c = mesh.comp
    if n % c:
        raise ValueError(f"{what}: {n} components do not divide by the mesh "
                         f"comp axis ({c}) -- adjust "
                         f"arch.tensorf.density_components / "
                         f"color_components or tpu.mesh_shape")
    b = n // c
    return slice(mesh.comp_index * b, (mesh.comp_index + 1) * b)


class _ReduceComp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        out = torch.clone(x, memory_format=torch.contiguous_format)
        return _all_reduce(mesh, out, "comp_forward", axis="comp")

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_comp(mesh: Mesh, x):
    """The sum of every comp rank's partial ``x``; the backward hands each
    rank the whole cotangent (module docstring)."""
    return _ReduceComp.apply(x, mesh)


class _CopyToComp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        flat = torch.cat([g.reshape(-1) for g in live])
        _all_reduce(ctx.mesh, flat, "comp_backward", axis="comp")
        out, at = [], 0
        for g in gs:
            if g is None:
                out.append(None)
                continue
            out.append(flat[at:at + g.numel()].reshape(g.shape))
            at += g.numel()
        return (None, *out)


def copy_to_comp(mesh: Mesh, xs: tuple) -> tuple:
    """``xs`` unchanged; their gradients summed over the comp group in one
    all_reduce (module docstring)."""
    return _CopyToComp.apply(mesh, *xs)


def gather_comp(mesh: Mesh, t, dim: int = -1):
    """Every comp rank's block of ``t`` along ``dim``, in comp order, on
    every rank: one all_reduce of the bits as int32, each rank's block in
    its place and zeros elsewhere, so the result is bit-exact (float32,
    bf16 and -0.0 included)."""
    if mesh.groups.get("comp") is ALONE:
        return t
    dim = dim % t.dim()
    n = t.shape[dim]
    t = t.detach().contiguous()
    bits = {4: torch.int32, 2: torch.int16}[t.element_size()]
    shape = list(t.shape)
    shape[dim] = n * mesh.comp
    buf = torch.zeros(shape, dtype=torch.int32, device=t.device)
    buf.narrow(dim, mesh.comp_index * n, n).copy_(t.view(bits))
    _all_reduce(mesh, buf, "comp_gather", axis="comp")
    return buf.to(bits).view(t.dtype)
