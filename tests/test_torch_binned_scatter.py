"""PyTorch port vs JAX: sample_plane_binned, the plane sample whose
plane gradient kernel K4 computes on the card, against the JAX entry point
that reaches the TPU kernel B3 (ops/binned_scatter.py, in interpret mode on
the CPU), and sample_plane / sample_line against the JAX plain samples.

Tolerances are the JAX test's own (tests/test_binned_scatter.py): the
forward at 1e-6, d_plane at rtol/atol 1e-4 (the scatter sums in another
order on each side), d_u / d_v at rtol 1e-6 and atol 1e-6 of their largest
entry (the same gather-only arithmetic, but each framework sums the R
channels of a sample in its own order, which moves a cancelling sum by a
few ulps of its terms).
K4 itself is held against this plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_tensorf_tpu.ops import sampling as jsampling
from joint_tensorf_tpu.ops.binned_scatter import (
    sample_plane_binned as jbinned)
from joint_tensorf_tpu_torch.ops import (binned_scatter, cuda_build, sampling,
                                         tile_scatter)
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()


def _inputs(H, W, R, N, seed, clustered=False):
    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((H, W, R)).astype(np.float32)
    if clustered:       # most tiles empty
        u = (rng.random(N) * 0.05 - 0.9).astype(np.float32)
        v = (rng.random(N) * 0.05 + 0.8).astype(np.float32)
    else:               # past [-1, 1] exercises the clamps
        u = rng.uniform(-1.2, 1.2, N).astype(np.float32)
        v = rng.uniform(-1.2, 1.2, N).astype(np.float32)
    g = rng.standard_normal((N, R)).astype(np.float32)
    return plane, u, v, g


CASES = [((37, 53, 16, 1000), False), ((11, 9, 4, 130), False),
         ((101, 101, 32, 4096), True)]


@pytest.mark.parametrize("shape,clustered", CASES)
def test_forward_and_vjp_match_jax(shape, clustered):
    plane, u, v, g = _inputs(*shape, seed=sum(shape), clustered=clustered)
    jargs = tuple(jnp.asarray(a) for a in (plane, u, v))
    want_out = np.asarray(jbinned(*jargs))
    want = jax.grad(lambda p, uu, vv: jnp.sum(jbinned(p, uu, vv) * g),
                    argnums=(0, 1, 2))(*jargs)

    targs = [torch.as_tensor(a).requires_grad_(True) for a in (plane, u, v)]
    cuda_build.reset_launches()
    out = binned_scatter.sample_plane_binned(*targs)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-6,
                               atol=1e-6)
    (out * torch.as_tensor(g)).sum().backward()
    assert cuda_build.LAUNCHES["binned_plane_scatter"] == 0   # plain path
    np.testing.assert_allclose(targs[0].grad.numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4, err_msg="d_plane")
    for name, t, ref in zip(("d_u", "d_v"), targs[1:], want[1:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("shape,clustered", CASES)
def test_plain_scatter_matches_the_tiled_fold(shape, clustered):
    """plane_grad_scatter_plain equals the JAX tile scatter + overlap-add
    (the function B3's kernel computes) on the same bins."""
    from joint_tensorf_tpu.ops.binned_scatter import (_pixel_bins,
                                                      _plane_grad_scatter)

    H, W, R, _ = shape
    _, u, v, g = _inputs(*shape, seed=7, clustered=clustered)
    jb = _pixel_bins(jnp.asarray(u), jnp.asarray(v), H, W)
    want = np.asarray(_plane_grad_scatter(jnp.asarray(g), *jb, H, W, R))
    tb = binned_scatter.pixel_bins(torch.as_tensor(u), torch.as_tensor(v),
                                   H, W)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = binned_scatter.plane_grad_scatter(torch.as_tensor(g), *tb, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_samples_match_jax():
    rng = np.random.default_rng(3)
    plane = rng.standard_normal((9, 13, 5)).astype(np.float32)
    line = rng.standard_normal((7, 5)).astype(np.float32)
    u, v, w = (rng.uniform(-1.2, 1.2, 200).astype(np.float32)
               for _ in range(3))
    t = torch.as_tensor
    np.testing.assert_allclose(
        sampling.sample_plane(t(plane), t(u), t(v)).numpy(),
        np.asarray(jsampling.sample_plane(plane, u, v)), atol=1e-6)
    np.testing.assert_allclose(
        sampling.sample_line(t(line), t(w)).numpy(),
        np.asarray(jsampling.sample_line(line, w)), atol=1e-6)


def _chunks(bk):
    """(tile, lo, hi) of each accumulate block of a bucketing table: the
    range [lo, hi) of perm that the block adds up (blocks past the last
    chunk have no tile)."""
    out = []
    for j, t in enumerate(bk.chunk_bucket.tolist()):
        if t < 0:
            continue
        lo = int(bk.offset[t]) + (j - int(bk.chunk_start[t])) * \
            binned_scatter.CHUNK
        out.append((t, lo, min(lo + binned_scatter.CHUNK,
                               int(bk.offset[t + 1]))))
    return out


@pytest.mark.parametrize("H,W,N", [(37, 53, 5000), (12, 12, 20000),
                                   (2, 1, 50)])
def test_tile_chunks_cover_every_sample_once(H, W, N):
    """K4's launch table (bucket_by_tile_plain, the layout the card's
    bucketing fills): every sample lies in exactly one chunk, of its own
    tile, of at most CHUNK samples, with its cell's key; every tile has a
    chunk (an empty tile's writes its zeros)."""
    rng = np.random.default_rng(N)
    u, v = (torch.as_tensor(rng.uniform(-1.2, 1.2, N).astype(np.float32))
            for _ in range(2))
    x0, y0, _, _ = binned_scatter.pixel_bins(u, v, H, W)
    bk = binned_scatter.bucket_by_tile_plain(x0, y0, H, W)
    p = binned_scatter.plan(N, H, W)
    TS = binned_scatter.TS
    assert all(t.dtype == torch.int32 for t in bk)
    seen = torch.zeros(N, dtype=torch.long)
    tiles = set()
    for t, a, b in _chunks(bk):
        assert 0 <= b - a <= binned_scatter.CHUNK
        assert b > a or int(bk.counts[t]) == 0
        tiles.add(t)
        idx = bk.perm[a:b, 0].long()
        seen[idx] += 1
        assert torch.all((y0[idx] // TS) * p.n_tx + x0[idx] // TS == t)
        assert torch.equal(bk.perm[a:b, 1].long(), binned_scatter.cell_key(
            x0[idx] % TS, y0[idx] % TS))
    assert torch.all(seen == 1)
    assert tiles == set(range(p.n_buckets))


@pytest.mark.parametrize("case", ["uniform", "march", "one_cell", "tiny"])
def test_plan_bounds_the_chunks_and_sizes_the_scratch(case):
    """plan() sizes K4's grid and arrays on the host, before any count is
    known: every tile's chunks (max(1, ceil(count / CHUNK))) fit the n_map
    accumulate blocks, and empty_bucketing gives each array the kernels'
    int32 shape."""
    rng = np.random.default_rng(5)
    H, W, N = {"uniform": (300, 300, 524288), "march": (400, 400, 200000),
               "one_cell": (257, 257, 100000), "tiny": (2, 1, 50)}[case]
    if case == "march":     # rays crossing the plane, clamped at its border
        start = rng.uniform(0, 399, (200, 2))
        step = rng.normal(0, 0.5, (200, 2))
        xy = np.clip(start[:, None] + np.arange(1000)[None, :, None]
                     * step[:, None], 0, 398).reshape(-1, 2)
        x0, y0 = (torch.as_tensor(xy[:, i]).long() for i in (0, 1))
    elif case == "one_cell":
        x0 = torch.full((N,), 5)
        y0 = torch.full((N,), 7)
    else:
        x0 = torch.as_tensor(rng.integers(0, max(W - 1, 1), N))
        y0 = torch.as_tensor(rng.integers(0, max(H - 1, 1), N))
    p = binned_scatter.plan(N, H, W)
    assert (p.n_ty, p.n_tx) == binned_scatter.tile_grid(H, W)
    assert p.n_buckets == p.n_ty * p.n_tx
    bk = binned_scatter.bucket_by_tile_plain(x0, y0, H, W)
    assert int(bk.chunk_start[-1]) <= p.n_map
    assert int(bk.offset[-1]) == N
    assert torch.all(bk.counts <= (bk.chunk_start[1:] - bk.chunk_start[:-1])
                     * binned_scatter.CHUNK)
    empty = tile_scatter.empty_bucketing(N, p, "cpu")
    assert [tuple(t.shape) for t in empty] == [tuple(t.shape) for t in bk]


def test_cell_keys_split_into_parity_classes():
    """The in-chunk sort key: a bijection of a tile's TS^2 cells onto
    [0, TS^2), each parity class a range of TS^2 / 4 keys, and two cells of
    one class share no corner pixel (csrc/binned_scatter.cu adds a cell's
    sums with a plain read-add-write on that ground)."""
    TS = binned_scatter.TS
    ly, lx = torch.meshgrid(torch.arange(TS), torch.arange(TS),
                            indexing="ij")
    key = binned_scatter.cell_key(lx, ly)
    assert sorted(key.flatten().tolist()) == list(range(TS * TS))
    q = TS * TS // 4
    for c in range(4):
        cls = (key >= c * q) & (key < (c + 1) * q)
        assert torch.all((ly[cls] % 2) * 2 + lx[cls] % 2 == c)
        xs, ys = lx[cls], ly[cls]
        near = ((xs[:, None] - xs[None]).abs() <= 1) & \
            ((ys[:, None] - ys[None]).abs() <= 1)
        assert torch.equal(near, torch.eye(q, dtype=torch.bool))


def test_shared_memory_holds_up_to_400_channels():
    """One accumulate block's shared memory (the tile, the chunk's sorted
    positions, the keys' starts) fits a Hopper block up to R = 400 and not
    much past it: plane_grad_scatter_cuda raises there."""
    assert binned_scatter.smem_bytes(64) <= binned_scatter._MAX_SMEM
    assert binned_scatter.smem_bytes(400) <= binned_scatter._MAX_SMEM
    assert binned_scatter.smem_bytes(480) > binned_scatter._MAX_SMEM
