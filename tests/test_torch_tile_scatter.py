"""PyTorch port vs JAX: scatter_add_rows_tiled, the row scatter-add that
kernel K5 computes on the card, against the JAX entry point that reaches
the TPU kernel B5 (ops/tile_scatter.py, in interpret mode on the CPU).

Tolerance atol 1e-4 / rtol 1e-5, the JAX test's own
(tests/test_tile_scatter.py): the two sides sum duplicate destinations in
another order.  K5 itself is held against this plain version on the card
by tests/test_torch_kernels_cuda.py, and its bucketing against a numpy
bucketing there; the host-side sizes of that bucketing (plan) are checked
here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_tensorf_tpu.ops.tile_scatter import (
    scatter_add_rows_tiled as jtiled)
from joint_tensorf_tpu_torch.ops import cuda_build, tile_scatter


@pytest.mark.parametrize("n,rows,c", [
    (1000, 300, 32),      # tiny destination, non-multiple N and C
    (130, 5000, 192),     # sparse: most blocks empty, C > 128
])
def test_matches_jax(n, rows, c):
    rng = np.random.default_rng(n)
    idx = rng.integers(0, rows, size=n)
    upd = rng.standard_normal((n, c)).astype(np.float32)
    want = np.asarray(jtiled(jnp.asarray(idx, jnp.int32), jnp.asarray(upd),
                             rows, interpret=True))
    cuda_build.reset_launches()
    got = tile_scatter.scatter_add_rows_tiled(torch.as_tensor(idx),
                                              torch.as_tensor(upd), rows)
    assert cuda_build.LAUNCHES["scatter_add_rows_tiled"] == 0  # plain path
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_single_hot_row():
    n, rows, c = 2048, 512, 64
    want = np.asarray(jtiled(jnp.full((n,), 77, jnp.int32),
                             jnp.ones((n, c), jnp.float32), rows,
                             interpret=True))
    got = tile_scatter.scatter_add_rows_tiled(
        torch.full((n,), 77), torch.ones((n, c)), rows).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[77, 0] == n and np.abs(got).sum() == n * c


def test_block_rows_fit_shared_memory():
    for c in (1, 5, 64, 192, 256, 4096):
        br = tile_scatter.block_rows(c)
        assert 1 <= br <= 256 and br * c * 4 <= 96 * 1024
    assert tile_scatter.block_rows(192) == 128


@pytest.mark.parametrize("case", ["uniform", "one_row", "sparse", "crowded"])
def test_plan_bounds_the_chunks_and_sizes_the_scratch(case):
    """plan() sizes the kernels' grid and arrays on the host, before any
    count is known: against a numpy bucketing, every bucket's chunks
    (max(1, ceil(count / CHUNK)), so an empty bucket still writes its
    rows) fit the n_map accumulate blocks, no chunk exceeds CHUNK samples,
    and empty_bucketing gives each array the kernels' int32 shape."""
    rng = np.random.default_rng(7)
    n, rows, c = {"uniform": (524288, 90000, 64),
                  "one_row": (524288, 90000, 64),
                  "sparse": (130, 5000, 192),
                  "crowded": (100000, 300, 5)}[case]
    idx = (np.full(n, 7) if case == "one_row"
           else rng.integers(0, rows, size=n))
    p = tile_scatter.plan(n, rows, c)
    assert p.BR == tile_scatter.block_rows(c)
    assert p.n_buckets * p.BR >= rows > (p.n_buckets - 1) * p.BR
    counts = np.bincount(idx // p.BR, minlength=p.n_buckets)
    chunks = np.maximum(1, -(-counts // tile_scatter.CHUNK))
    assert chunks.sum() <= p.n_map
    assert np.all(counts <= chunks * tile_scatter.CHUNK)
    bk = tile_scatter.empty_bucketing(n, p, "cpu")
    nb = p.n_buckets
    assert {k: tuple(t.shape) for k, t in bk._asdict().items()} == {
        "perm": (n, 2), "counts": (nb,), "offset": (nb + 1,),
        "cursor": (nb,), "chunk_start": (nb + 1,), "chunk_bucket": (p.n_map,)}
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in bk)
