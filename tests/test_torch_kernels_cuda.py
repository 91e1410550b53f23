"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA card: every test skips without one (a CUDA kernel has no
CPU mode; the plain versions are held against JAX by the other
tests/test_torch_*.py files).  This file imports no JAX, so on a machine
with a card and without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: the compositor at rtol 1e-4 / atol 1e-5 (the kernels' scans
round differently from the sequential cumprod; in the forward a weight
within an ulp of the gate threshold may flip its gate, which moves rgb_map
by at most thres; the backward takes the forward's weights, so its gate is
exact); the row scatter K3 at rtol 1e-5 / atol 1e-4, the
binned plane scatter K4 and the block-local row scatter K5 at 1e-5 of the
output's largest magnitude (atomics sum in an order that varies from run
to run).
"""
import pytest
import torch

from joint_tensorf_tpu_torch.ops import composite as C
from joint_tensorf_tpu_torch.ops import segment_scatter
from joint_tensorf_tpu_torch.utils import setup_torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    setup_torch()


@pytest.mark.cuda
@pytest.mark.parametrize("thres", [float("-inf"), 1e-6])
@pytest.mark.parametrize("n,s", [(2028, 221), (37, 5), (3, 64)])
def test_compositor_kernels_match_plain(thres, n, s):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    alpha = torch.rand((n, s), generator=gen, device="cuda") ** 4 * 0.5
    alpha[0] = 1.0                        # exactly saturated
    alpha[1, ::3] = 1.0
    alpha[-1] = 1e-7                      # weights below the threshold
    rgb = torch.rand((n, s, 3), generator=gen, device="cuda")
    z = torch.cumsum(torch.rand((n, s), generator=gen, device="cuda"), -1)
    cots = (torch.randn((n, 3), generator=gen, device="cuda"),
            torch.randn((n,), generator=gen, device="cuda"),
            torch.randn((n,), generator=gen, device="cuda"),
            torch.randn((n, s), generator=gen, device="cuda"))
    got = C.composite_fwd_cuda(alpha, rgb, z, thres)
    want = C.composite_fwd_plain(alpha, rgb, z, thres)
    got_b = C.composite_bwd_cuda(alpha, rgb, z, got[3], thres, *cots)
    want_b = C.composite_bwd_plain(alpha, rgb, z, got[3], thres, *cots)
    torch.cuda.synchronize()
    for a, b in zip(list(got) + list(got_b), list(want) + list(want_b)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _ray_inputs(n, s, gen):
    """alpha with an optical depth of a few units per ray whatever S, so
    that T stays away from 0 across tiles, and depths between the scene's
    near and far planes; ray 0 saturated (alpha == 1.0 exactly), ray 1
    saturated at every third sample."""
    alpha = torch.rand((n, s), generator=gen, device="cuda") * min(
        0.5, 8.0 / s)
    alpha[0] = 1.0
    alpha[1, ::3] = 1.0
    rgb = torch.rand((n, s, 3), generator=gen, device="cuda")
    z = 2.0 + torch.cumsum(torch.rand((n, s), generator=gen, device="cuda"),
                           -1) * (4.0 / s)          # depths in [2, 6]
    cots = (torch.randn((n, 3), generator=gen, device="cuda"),
            torch.randn((n,), generator=gen, device="cuda"),
            torch.randn((n,), generator=gen, device="cuda"),
            torch.randn((n, s), generator=gen, device="cuda"))
    return alpha, rgb, z, cots


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 31, 32, 33, 255, 256, 257, 1000, 1025,
                               4100])
def test_compositor_bwd_over_ray_lengths(s):
    """K2 at every block shape it picks from S (128 x 1 .. 256 x 8) and
    across tiles (S > 2048), saturated rays included."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(s)
    alpha, rgb, z, cots = _ray_inputs(5, s, gen)
    w = C.composite_fwd_cuda(alpha, rgb, z, 1e-6)[3]
    for g_weights in (cots[3], None):     # None: the training step's case
        args = (alpha, rgb, z, w, 1e-6, *cots[:3], g_weights)
        got = C.composite_bwd_cuda(*args)
        want = C.composite_bwd_plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_compositor_bwd_gate_is_the_forwards():
    """With weights on the threshold, K2 gates exactly as weights > thres;
    and it reads the gate from the weights it is given."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    alpha, rgb, z, cots = _ray_inputs(64, 300, gen)
    w = C.composite_fwd_cuda(alpha, rgb, z, float("-inf"))[3]
    thres = float(w[5].median())              # a weight exactly on it
    w2 = w.clone()                            # one weight nudged above it
    below = (w2 <= thres).nonzero()[0]
    w2[below[0], below[1]] = torch.nextafter(
        torch.tensor(thres, device="cuda"), torch.tensor(1.0, device="cuda"))
    for weights in (w, w2):
        gate = weights > thres
        assert (weights == thres).any() and gate.any() and not gate.all()
        _, d_rgb, d_z = C.composite_bwd_cuda(alpha, rgb, z, weights, thres,
                                             *cots)
        want = torch.where(gate[..., None],
                           cots[0][:, None, :] * weights[..., None], 0.0)
        assert torch.equal(d_rgb, want)
        assert torch.equal(d_z, cots[1][:, None] * weights)


@pytest.mark.cuda
def test_compositor_autograd_takes_the_kernels():
    _need_card()
    from joint_tensorf_tpu_torch.ops import cuda_build

    gen = torch.Generator(device="cuda").manual_seed(1)
    alpha = (torch.rand((64, 50), generator=gen, device="cuda") * 0.2
             ).requires_grad_(True)
    rgb = torch.rand((64, 50, 3), generator=gen,
                     device="cuda").requires_grad_(True)
    z = torch.cumsum(torch.rand((64, 50), generator=gen, device="cuda"), -1)
    cuda_build.reset_launches()
    rgb_map, _, acc, _ = C.composite(alpha, rgb, z, 1e-6)
    (rgb_map.sum() + acc.sum()).backward()
    assert cuda_build.LAUNCHES["composite_fwd"] == 1
    assert cuda_build.LAUNCHES["composite_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,c", [(448188 // 8, 4096, 256),
                                      (20000, 160000, 64), (1000, 7, 5)])
def test_scatter_kernel_matches_plain(n, rows, c):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, rows, (n,), generator=gen, device="cuda")
    idx, _ = torch.sort(idx)                 # long runs, like march order
    upd = torch.randn((n, c), generator=gen, device="cuda")
    got = segment_scatter.scatter_add_rows(idx, upd, rows)
    want = segment_scatter.scatter_add_rows_plain(idx, upd, rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,r,n,spread", [
    (300, 300, 64, 524288, 1.0), (37, 53, 16, 1000, 1.2), (11, 9, 4, 130, 1.2),
    (101, 101, 32, 4096, 0.02), (2, 1, 8, 50, 1.2),
    (12, 12, 8, 20000, 1.0)])          # tiles of ~5000 samples: 3 chunks
def test_binned_scatter_kernel_matches_plain(h, w, r, n, spread):
    _need_card()
    from joint_tensorf_tpu_torch.ops import binned_scatter as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    u = (torch.rand((n,), generator=gen, device="cuda") * 2 - 1) * spread
    v = (torch.rand((n,), generator=gen, device="cuda") * 2 - 1) * spread
    g = torch.randn((n, r), generator=gen, device="cuda")
    bins = K.pixel_bins(u, v, h, w)
    got = K.plane_grad_scatter(g, *bins, h, w)
    want = K.plane_grad_scatter_plain(g, *bins, h, w)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,c", [(524288, 90000, 64), (1000, 300, 32),
                                      (130, 5000, 192), (2048, 512, 5)])
def test_tile_scatter_kernel_matches_plain(n, rows, c):
    _need_card()
    from joint_tensorf_tpu_torch.ops import tile_scatter as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, rows, (n,), generator=gen, device="cuda")
    upd = torch.randn((n, c), generator=gen, device="cuda")
    got = K.scatter_add_rows_tiled(idx, upd, rows)
    want = K.scatter_add_rows_tiled_plain(idx, upd, rows)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    hot = K.scatter_add_rows_tiled(torch.full((n,), 7, device="cuda"),
                                   torch.ones((n, c), device="cuda"), rows)
    assert float(hot[7, 0]) == n and float(hot.abs().sum()) == n * c


def _tile_case(case, n, rows, gen):
    """Indices of one K5 edge case (some outside [0, rows) for "dropped")."""
    if case == "one_bucket":       # every sample in block 0: many chunks
        return torch.randint(0, 200, (n,), generator=gen, device="cuda")
    idx = torch.randint(0, rows, (n,), generator=gen, device="cuda")
    if case == "dropped":
        idx[::7] = -3
        idx[1::7] = rows + 5
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case,n,rows,c", [
    ("one_bucket", 10000, 5000, 64),    # 1 bucket of 5 chunks, 19 empty
    ("uniform", 1000, 100000, 64),      # most buckets empty
    ("uniform", 5000, 1000, 32),        # n_rows not a multiple of BR
    ("uniform", 4000, 700, 5),          # C % 4 != 0: scalar loads
    ("uniform", 20000, 3000, 192),      # C > 128: two element passes
    ("uniform", 2000, 13000, 24576),    # 13000 buckets of 1 row: counters
                                        # beyond shared memory
    ("dropped", 6000, 900, 64)])        # indices outside [0, n_rows)
def test_tile_scatter_edge_cases(idx_dtype, case, n, rows, c):
    _need_card()
    from joint_tensorf_tpu_torch.ops import tile_scatter as K

    gen = torch.Generator(device="cuda").manual_seed(n)
    idx = _tile_case(case, n, rows, gen).to(idx_dtype)
    upd = torch.randn((n, c), generator=gen, device="cuda")
    got = K.scatter_add_rows_tiled(idx, upd, rows)
    keep = (idx >= 0) & (idx < rows)
    want = K.scatter_add_rows_tiled_plain(idx[keep], upd[keep], rows)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_bucket", "uniform", "dropped"])
def test_tile_bucketing_covers_every_sample_once(case):
    """bucket_by_block against a numpy bucketing: each in-range sample in
    its bucket's range once, chunks of at most CHUNK samples, one chunk for
    an empty bucket, and -1 past the last chunk."""
    _need_card()
    import numpy as np

    from joint_tensorf_tpu_torch.ops import tile_scatter as K

    n, rows, c = 9000, 3000, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    idx = _tile_case(case, n, rows, gen)
    p = K.plan(n, rows, c)
    bk, _ = K.bucket_by_block(idx, rows, c)
    v = {k: t.cpu().numpy() for k, t in bk._asdict().items()}
    ix = idx.cpu().numpy()
    keep = (ix >= 0) & (ix < rows)
    counts = np.bincount(ix[keep] // p.BR, minlength=p.n_buckets)
    np.testing.assert_array_equal(v["counts"], counts)
    np.testing.assert_array_equal(v["offset"],
                                  np.concatenate([[0], np.cumsum(counts)]))
    chunks = np.maximum(1, -(-counts // K.CHUNK))
    np.testing.assert_array_equal(v["chunk_start"],
                                  np.concatenate([[0], np.cumsum(chunks)]))
    np.testing.assert_array_equal(
        v["chunk_bucket"], np.concatenate([np.repeat(np.arange(p.n_buckets),
                                                     chunks),
                                           -np.ones(p.n_map - chunks.sum(),
                                                    np.int32)]))
    perm = v["perm"][:keep.sum()]
    assert sorted(perm[:, 0]) == sorted(np.flatnonzero(keep))
    for b in range(p.n_buckets):
        pos, row = perm[v["offset"][b]:v["offset"][b + 1]].T
        np.testing.assert_array_equal(ix[pos], b * p.BR + row)


@pytest.mark.cuda
def test_binned_sample_takes_the_kernel():
    _need_card()
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.ops.binned_scatter import sample_plane_binned
    from joint_tensorf_tpu_torch.ops.sampling import sample_plane

    gen = torch.Generator(device="cuda").manual_seed(2)
    plane = torch.randn((40, 30, 8), generator=gen, device="cuda")
    u = torch.rand((500,), generator=gen, device="cuda") * 2.2 - 1.1
    v = torch.rand((500,), generator=gen, device="cuda") * 2.2 - 1.1
    g = torch.randn((500, 8), generator=gen, device="cuda")
    grads = []
    for fn in (sample_plane_binned, sample_plane):
        args = [t.clone().requires_grad_(True) for t in (plane, u, v)]
        (fn(*args) * g).sum().backward()
        grads.append([a.grad for a in args])
    cuda_build.reset_launches()
    args = [t.clone().requires_grad_(True) for t in (plane, u, v)]
    (sample_plane_binned(*args) * g).sum().backward()
    assert cuda_build.LAUNCHES["binned_plane_scatter"] == 1
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs():
    _need_card()
    idx = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        segment_scatter.scatter_add_rows_cuda(
            idx, torch.zeros((4, 3), device="cuda"), 5)
    a = torch.zeros((4, 6), device="cuda")
    with pytest.raises(ValueError):
        C.composite_fwd_cuda(a, torch.zeros((4, 6, 3), device="cuda").
                             transpose(0, 1).contiguous().transpose(0, 1),
                             a, 0.0)
