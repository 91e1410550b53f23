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
exact); the row scatter K3 at rtol 1e-5 / atol 1e-4 (through the dense
grid's sample, card against CPU, at rtol / atol 1e-5), the
binned plane scatter K4 and the block-local row scatter K5 at 1e-5 of the
output's largest magnitude (atomics sum in an order that varies from run
to run), and exactly where every partial sum is exact (integer updates);
the lane grid's samples card against CPU (through K3) at rtol / atol
1e-5, the hybrids', the chunked fused sample's and sample_line's at rtol
1e-5 and 1e-5 of each output's largest magnitude (the coordinates'
gradients scale with the grid's size).  The summed density sample K6
against its plain version on the card: the feature within 1e-5 of its
largest magnitude (the group's shuffle sums the channels in another
order), the plane, line and coordinate gradients at rtol 1e-5 and 1e-5
of each gradient's largest magnitude (each slot's sum in another order,
and the factor gradients' float32 atomics in an order that varies from
run to run); the dead slots' feature and coordinate gradients exactly 0.
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
    for g_weights in (cots[3], None):     # None: the dense appearance
        args = (alpha, rgb, z, w, 1e-6, *cots[:3], g_weights)
        got = C.composite_bwd_cuda(*args)
        want = C.composite_bwd_plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 31, 32, 33, 255, 256, 257, 1000, 1025,
                               4100])
def test_compositor_fwd_over_ray_lengths(s):
    """K1 at both thread shapes it picks from S (64 x 4, 64 x 8) and
    across tiles (S > 256 and S > 768: T carried), with 7 rays so that the
    last block holds a ray that does not exist; saturated rays and a ray
    whose T underflows give finite values and zero weights past the
    saturation; K2 given the new K1's weights still matches its plain
    version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(100 + s)
    alpha, rgb, z, cots = _ray_inputs(7, s, gen)
    alpha[2] = 0.9                        # T underflows after ~40 samples
    for thres in (float("-inf"), 1e-6):
        got = C.composite_fwd_cuda(alpha, rgb, z, thres)
        want = C.composite_fwd_plain(alpha, rgb, z, thres)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        w = got[3]
        # alpha == 1.0 at sample 0: T = 1e-10, 1e-20, ... then 0
        assert torch.all(w[0, 1:] <= 1e-10) and torch.all(w[0, 5:] == 0)
        if s > 60:
            assert torch.all(w[2, 60:] == 0)
        args = (alpha, rgb, z, w, thres, *cots[:3], None)
        for a, b in zip(C.composite_bwd_cuda(*args),
                        C.composite_bwd_plain(*args)):
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
def test_dense_grid_sample_takes_k3():
    """sample_packed_grid's backward (the dense grid's row scatter) goes
    through K3 on the card, once, and equals the CPU's index_add_ route."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import cuda_build, densify

    gen = torch.Generator().manual_seed(2)
    G = torch.randn((23, 19, 29), generator=gen)
    coords = tuple(torch.rand((5000,), generator=gen) * 2.2 - 1.1
                   for _ in range(3))
    cot = torch.randn((5000,), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        g = G.to(dev).requires_grad_(True)
        c = tuple(x.to(dev).requires_grad_(True) for x in coords)
        cuda_build.reset_launches()
        val = densify.sample_packed_grid(densify.pack_corners(g), c)
        grads = torch.autograd.grad((val * cot.to(dev)).sum(), (g,) + c)
        out[dev] = [t.detach().cpu() for t in (val,) + grads]
        assert cuda_build.LAUNCHES["scatter_add_rows"] == (dev == "cuda")
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _scatter_case(case, n, rows, c, gen):
    """K3's inputs for one case: "sorted" (long runs, like march order),
    "uniform", "runs" (runs of 45 rows: they cross the narrow route's warp
    and block edges and the wide route's group edges), "one_row" (every row
    to one destination, integer-valued updates: every partial sum is
    exact), "dropped" (sorted, every 7th index negative and the next one
    past n_rows) or "unaligned" (sorted, updates 4 bytes off 16-byte
    alignment: the scalar route)."""
    if case == "runs":
        idx = (torch.arange(n, device="cuda") // 45) % rows
    elif case == "one_row":
        idx = torch.full((n,), rows // 2, device="cuda")
    else:
        idx = torch.randint(0, rows, (n,), generator=gen, device="cuda")
        if case != "uniform":
            idx, _ = torch.sort(idx)
    if case == "dropped":
        idx[::7] = -3
        idx[1::7] = rows + 5
    if case == "one_row":
        upd = torch.randint(-4, 5, (n, c), generator=gen,
                            device="cuda").float()
    elif case == "unaligned":
        upd = torch.randn((n * c + 1,), generator=gen,
                          device="cuda")[1:].view(n, c)
        assert upd.is_contiguous() and upd.data_ptr() % 16 != 0
    else:
        upd = torch.randn((n, c), generator=gen, device="cuda")
    return idx, upd


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,rows,c", [
    ("sorted", 448188 // 8, 4096, 256), ("sorted", 20000, 160000, 64),
    ("sorted", 1000, 7, 5),
    ("sorted", 56023, 262144, 8),       # the dense grid; N % 32 != 0
    *[("runs", 10001, 997, c) for c in (8, 5, 64, 192, 256, 4, 12, 16, 32)],
    ("uniform", 33, 5, 8), ("uniform", 20000, 3000, 64),
    ("one_row", 50000, 100, 8), ("one_row", 50000, 100, 256),
    ("one_row", 5000, 100, 5),
    ("dropped", 6000, 900, 8), ("dropped", 6000, 900, 5),
    ("dropped", 6000, 900, 192),
    ("unaligned", 3000, 500, 8), ("unaligned", 3000, 500, 64),
    ("sorted", 2028 * 100, 423 * 359 * 420, 8)])   # the 64M-voxel grid
def test_scatter_kernel_matches_plain(case, n, rows, c):
    """K3 on both routes (narrow: C % 4 == 0 up to 16 channels; wide: the
    rest, with scalar loads when C % 4 != 0 or the updates are not 16-byte
    aligned) against index_add_ on the rows it keeps."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + c)
    idx, upd = _scatter_case(case, n, rows, c, gen)
    got = segment_scatter.scatter_add_rows(idx, upd, rows)
    keep = (idx >= 0) & (idx < rows)
    want = segment_scatter.scatter_add_rows_plain(idx[keep], upd[keep], rows)
    torch.cuda.synchronize()
    if case == "one_row":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 8, 12, 16, 24, 32, 48, 64, 96, 128])
def test_scatter_kernel_at_the_comp_widths(c):
    """K3 at the channel counts the comp layout gives it (4 packed corners
    x a rank's share of a plane's components: BAT's 16 / 48 / 64 fused
    and LLFF's 4 / 12 / 16 / 48 components at C = 2 and 4) on a rank's
    march-order rows into a 400 x 400 plane, against index_add_."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(c)
    n, rows = 2048 * 64, 400 * 400
    idx, upd = _scatter_case("sorted", n, rows, c, gen)
    got = segment_scatter.scatter_add_rows(idx, upd, rows)
    want = segment_scatter.scatter_add_rows_plain(idx, upd, rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,rows,c", [
    ("sorted", 2028 * 64, 64 * 48 * 4, 128),    # the lane grid's rows
    ("sorted", 20000, 9 * 7 * 2, 128),
    ("one_row", 50000, 300, 128),
    ("sorted", 2028 * 128, 420, 96),            # an appearance line
    ("sorted", 2028 * 200, 420, 32),            # a density line
    ("one_row", 2028 * 128, 420, 96), ("one_row", 2028 * 200, 420, 32)])
def test_scatter_kernel_at_the_rest_shapes(case, n, rows, c):
    """K3 at the lane grid's 128 channels into X*Y*Zb rows and at a
    line's 2R channels into 420 rows (the hybrid line's backward), in
    march order and with every sample in one row, against index_add_."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + c + rows)
    idx, upd = _scatter_case(case, n, rows, c, gen)
    got = segment_scatter.scatter_add_rows(idx, upd, rows)
    want = segment_scatter.scatter_add_rows_plain(idx, upd, rows)
    torch.cuda.synchronize()
    if case == "one_row":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_scatter_shapes_are_noted_at_the_launch():
    """K3's wrapper notes each (C, n_rows) it launched at with the most
    rows N of one launch there (cuda_build.SCATTER_SHAPES), beside its
    count; reset_launches clears both."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import cuda_build

    gen = torch.Generator(device="cuda").manual_seed(3)
    cuda_build.reset_launches()
    for n, rows, c in ((5000, 420, 96), (7000, 420, 96), (300, 9, 8)):
        idx, upd = _scatter_case("sorted", n, rows, c, gen)
        segment_scatter.scatter_add_rows(idx, upd, rows)
    assert cuda_build.LAUNCHES["scatter_add_rows"] == 3
    assert cuda_build.SCATTER_SHAPES == {(96, 420): 7000, (8, 9): 300}
    cuda_build.reset_launches()
    assert cuda_build.SCATTER_SHAPES == {}


def _card_and_cpu(fn, inputs, cot):
    """fn's value and its gradients w.r.t. every input on the CPU and on
    the card, and the K3 launches of the card's call."""
    from joint_tensorf_tpu_torch.ops import cuda_build

    out = {}
    for dev in ("cpu", "cuda"):
        xs = [x.to(dev).requires_grad_(True) for x in inputs]
        cuda_build.reset_launches()
        val = fn(*xs)
        grads = torch.autograd.grad((val * cot.to(dev)).sum(), xs)
        out[dev] = [t.detach().cpu() for t in (val,) + grads]
        if dev == "cuda":
            out["launches"] = cuda_build.LAUNCHES["scatter_add_rows"]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("row_dtype", ["float32", "bfloat16"])
def test_lane_grid_sample_takes_k3(row_dtype):
    """sample_lane_grid(pack_lane_grid(G))'s backward goes through K3 once
    at 128 channels and equals the CPU's index_add_ route."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import lane_grid

    gen = torch.Generator().manual_seed(4)
    G = torch.randn((23, 19, 70), generator=gen)
    coords = [torch.rand((6000,), generator=gen) * 2.2 - 1.1
              for _ in range(3)]
    coords[0][:3] = torch.tensor([-1.0, 1.0, 1.0])
    out = _card_and_cpu(
        lambda g, x, y, z: lane_grid.sample_lane_grid(
            lane_grid.pack_lane_grid(g), (x, y, z), 70, row_dtype),
        [G] + coords, torch.randn((6000,), generator=gen))
    assert out["launches"] == 1
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plane", "line"])
def test_hybrid_samples_take_k3(kind):
    """The hybrid plane's and line's backwards go through K3 once (4R or
    2R channels) and equal the CPU's index_add_ route, coordinates'
    gradients included (1e-5 of each output's largest magnitude)."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import sampling

    gen = torch.Generator().manual_seed(5)
    n = 8000
    table = torch.randn((33, 17, 48) if kind == "plane" else (420, 16),
                        generator=gen)
    coords = [torch.rand((n,), generator=gen) * 2.2 - 1.1
              for _ in range(2 if kind == "plane" else 1)]
    fn = (sampling.sample_plane_hybrid if kind == "plane"
          else sampling.sample_line_hybrid)
    out = _card_and_cpu(fn, [table] + coords,
                        torch.randn((n, table.shape[-1]), generator=gen))
    assert out["launches"] == 1
    # the coordinates' gradients carry the cell size's factor 0.5 (D - 1):
    # held at 1e-5 of each output's largest magnitude
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1 << 20, 1000])
def test_chunked_factor_sample_takes_k3(monkeypatch, chunk):
    """The fused factor sample's backward in chunks of _PROD_BWD_CHUNK
    samples (one chunk, and 8 of at most 1000) goes through K3 twice a
    chunk (the plane's 4R and the line's 2R channels) and equals the
    CPU's index_add_ route; sample_line's through K3 once (1e-5 of each
    output's largest magnitude)."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import sampling

    monkeypatch.setattr(sampling, "_PROD_BWD_CHUNK", chunk)
    gen = torch.Generator().manual_seed(6)
    n = 7500
    plane = torch.randn((33, 17, 16), generator=gen)
    line = torch.randn((420, 16), generator=gen)
    coords = [torch.rand((n,), generator=gen) * 2.2 - 1.1 for _ in range(3)]
    cot = torch.randn((n, 16), generator=gen)
    for fn, inputs, want in (
            (sampling.sample_planeline_prod, [plane, line] + coords,
             2 * -(-n // chunk)),
            (sampling.sample_line, [line, coords[2]], 1)):
        out = _card_and_cpu(fn, inputs, cot)
        assert out["launches"] == want
        for a, b in zip(out["cuda"], out["cpu"]):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()))


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


def _dirty_cache(n_floats):
    """Leave NaN in the caching allocator's free blocks, so that an output
    the kernels fail to write shows up as NaN."""
    torch.full((n_floats,), float("nan"), device="cuda")
    torch.cuda.synchronize()


def _check_binned(g, x0, y0, fx, fy, h, w, exact=False):
    from joint_tensorf_tpu_torch.ops import binned_scatter as K

    _dirty_cache(h * w * g.shape[1])
    got = K.plane_grad_scatter(g, x0, y0, fx, fy, h, w)
    want = K.plane_grad_scatter_plain(g, x0, y0, fx, fy, h, w)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if exact:
        assert torch.equal(got, want)
    else:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


def _march_bins(n_rays, s, h, w, gen):
    """Cells and fractions of n_rays x s samples in march order: each ray
    steps across the plane by at most half a cell, and is clamped onto the
    border once it leaves."""
    from joint_tensorf_tpu_torch.ops import binned_scatter as K

    start = torch.rand((n_rays, 2), generator=gen, device="cuda") * \
        torch.tensor([w - 1.0, h - 1.0], device="cuda")
    step = (torch.rand((n_rays, 2), generator=gen, device="cuda") - 0.5)
    t = torch.arange(s, device="cuda", dtype=torch.float32)[None, :, None]
    pos = (start[:, None] + t * step[:, None]).reshape(-1, 2)
    u = pos[:, 0] * (2.0 / (w - 1)) - 1.0
    v = pos[:, 1] * (2.0 / (h - 1)) - 1.0
    return K.pixel_bins(u, v, h, w)


@pytest.mark.cuda
def test_binned_scatter_march_order():
    """K4 on samples in march order: runs of one cell, tiles crowded at the
    border, several chunks per tile (the contended case)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    bins = _march_bins(300, 500, 120, 90, gen)
    g = torch.randn((bins[0].shape[0], 64), generator=gen, device="cuda")
    _check_binned(g, *bins, 120, 90)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3000, 50000])
def test_binned_scatter_one_cell_is_exact(n):
    """Every sample in one cell with dyadic fractions and integer g: every
    partial sum is exact, so the kernel must equal the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n)
    g = torch.randint(-4, 5, (n, 64), generator=gen, device="cuda").float()
    x0 = torch.full((n,), 15, device="cuda")
    y0 = torch.full((n,), 9, device="cuda")
    fx = torch.full((n,), 0.5, device="cuda")
    fy = torch.full((n,), 0.25, device="cuda")
    _check_binned(g, x0, y0, fx, fy, 31, 23, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(57, 43), (21, 21), (2, 1), (1, 7)])
def test_binned_scatter_border_tiles(h, w):
    """Most samples clamped onto the plane's last row and column (x0 =
    W-2, y0 = H-2): the border tiles take most of N over many chunks; odd,
    tiny and one-wide planes."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import binned_scatter as K

    gen = torch.Generator(device="cuda").manual_seed(h * w)
    n = 30000
    u = (torch.rand((n,), generator=gen, device="cuda") * 2 - 1) * 3.0
    v = (torch.rand((n,), generator=gen, device="cuda") * 2 - 1) * 3.0
    x0, y0, fx, fy = K.pixel_bins(u, v, h, w)
    g = torch.randn((n, 16), generator=gen, device="cuda")
    _check_binned(g, x0, y0, fx, fy, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [4, 5, 16, 64, 192])
def test_binned_scatter_channels(r):
    """R from 4 to 192: one float4 lane a worker up to a whole warp in
    passes of 32 vectors; R = 5 takes scalar loads."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(r)
    bins = _march_bins(100, 300, 64, 80, gen)
    g = torch.randn((bins[0].shape[0], r), generator=gen, device="cuda")
    _check_binned(g, *bins, 64, 80)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "march", "one_cell"])
def test_binned_bucketing_covers_every_sample_once(case):
    """bucket_by_tile against the plain bucketing (numpy-checked on the
    CPU): the same counts, offsets and chunk map, each bucket's range
    holding exactly its tile's samples, each with its cell's key."""
    _need_card()
    import numpy as np

    from joint_tensorf_tpu_torch.ops import binned_scatter as K

    h, w, n = 97, 83, 40000
    gen = torch.Generator(device="cuda").manual_seed(7)
    if case == "march":
        x0, y0, _, _ = _march_bins(80, 500, h, w, gen)
    elif case == "one_cell":
        x0 = torch.full((n,), 41, device="cuda")
        y0 = torch.full((n,), 60, device="cuda")
    else:
        x0 = torch.randint(0, w - 1, (n,), generator=gen, device="cuda")
        y0 = torch.randint(0, h - 1, (n,), generator=gen, device="cuda")
    bk, _ = K.bucket_by_tile(x0, y0, h, w, 8)
    want = K.bucket_by_tile_plain(x0.cpu(), y0.cpu(), h, w)
    got = {k: t.cpu().numpy() for k, t in bk._asdict().items()}
    want = {k: t.numpy() for k, t in want._asdict().items()}
    for k in ("counts", "offset", "cursor", "chunk_start", "chunk_bucket"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for b in range(len(want["counts"])):
        lo, hi = want["offset"][b], want["offset"][b + 1]
        g_rows = got["perm"][lo:hi]
        np.testing.assert_array_equal(np.sort(g_rows[:, 0]),
                                      want["perm"][lo:hi, 0])
        order = np.argsort(g_rows[:, 0])
        np.testing.assert_array_equal(g_rows[order, 1],
                                      want["perm"][lo:hi, 1])


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


def _density_case(kind, gen):
    """K6's inputs: three planes, lines and coordinates, the live mask.
    "masked" is the masked cell's shape: 400^2 x 16 planes, 400 x 16
    lines, 2500 rays x K 896 slots, each ray's live slots a prefix of
    about 5% (0-96 of 896) along a march through the box; "scalar" widths
    that are no multiple of 4 (5 / 3 / 7, scalar loads and atomics);
    "global_lines" lines too long for the block's shared copy (3 x 4000 x
    12 floats), every slot live (live None)."""
    from joint_tensorf_tpu_torch.models import vm

    res, ranks, rays, K = {
        "masked": ((400, 400, 400), (16, 16, 16), 2500, 896),
        "scalar": ((37, 29, 41), (5, 3, 7), 300, 64),
        "global_lines": ((4000, 4000, 4000), (12, 12, 12), 200, 64)}[kind]
    planes, lines = [], []
    for (m0, m1, vec), r in zip(vm.AXES, ranks):
        h, w = (res[m1], res[m0]) if kind != "global_lines" else (60, 50)
        planes.append(torch.randn((h, w, r), generator=gen, device="cuda"))
        lines.append(torch.randn((res[vec], r), generator=gen,
                                 device="cuda"))
    start = torch.rand((rays, 1, 3), generator=gen, device="cuda") * 2.2 - 1.1
    step = (torch.rand((rays, 1, 3), generator=gen, device="cuda") - 0.5) \
        * (4.0 / K)
    pts = (start + torch.arange(K, device="cuda")[None, :, None] * step)
    coords = [pts[..., a].reshape(-1).contiguous() for a in range(3)]
    n_live = torch.randint(0, 97 if kind == "masked" else K // 2,
                           (rays, 1), generator=gen, device="cuda")
    live = (torch.arange(K, device="cuda")[None] < n_live).reshape(-1)
    if kind == "global_lines":
        live = None
    return planes, lines, coords, live


def _density_grads(fn, planes, lines, coords, live, cot, need):
    """fn's value and the gradients ``need`` (nine flags) asks for."""
    from joint_tensorf_tpu_torch.models import vm

    xs = [t.detach().requires_grad_(w)
          for t, w in zip(planes + lines + coords, need)]
    val = fn(xs[0:3], xs[3:6], xs[6:9], vm.AXES, live)
    asked = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad((val * cot).sum(), asked)
    it = iter(grads)
    return val.detach(), [next(it) if x.requires_grad else None for x in xs]


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-5,
                               atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["masked", "scalar", "global_lines"])
def test_density_sample_kernel_matches_plain(kind):
    """K6 through sample_planeline_prod_sum against its plain version on
    the card: the feature, the nine gradients, zeros at the dead slots,
    one launch each way and no K3."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import cuda_build, sampling

    gen = torch.Generator(device="cuda").manual_seed(21)
    planes, lines, coords, live = _density_case(kind, gen)
    cot = torch.randn(coords[0].shape, generator=gen, device="cuda")
    want, want_g = _density_grads(sampling.sample_planeline_prod_sum_plain,
                                  planes, lines, coords, live, cot,
                                  (True,) * 9)
    cuda_build.reset_launches()
    got, got_g = _density_grads(sampling.sample_planeline_prod_sum, planes,
                                lines, coords, live, cot, (True,) * 9)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["density_sample_fwd"] == 1
    assert cuda_build.LAUNCHES["density_sample_bwd"] == 1
    assert cuda_build.LAUNCHES["scatter_add_rows"] == 0
    _close(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.isfinite(a).all()
        _close(a, b)
    if live is not None:
        assert 0.02 < float(live.float().mean()) < 0.5
        assert torch.count_nonzero(got[~live]) == 0
        assert all(torch.count_nonzero(d[~live]) == 0 for d in got_g[6:])
    assert all(torch.count_nonzero(d) > 0 for d in got_g)


@pytest.mark.cuda
def test_density_sample_kernel_frozen_and_detached():
    """At the masked shape: frozen factors give the coordinates' gradients
    of the full backward bit for bit (each slot's sum is the same) and no
    factor gradient; detached coordinates give the factors' gradients
    (within the atomics' order) and none for the coordinates; one
    backward launch each."""
    _need_card()
    from joint_tensorf_tpu_torch.ops import cuda_build, sampling

    gen = torch.Generator(device="cuda").manual_seed(22)
    planes, lines, coords, live = _density_case("masked", gen)
    cot = torch.randn(coords[0].shape, generator=gen, device="cuda")
    fn = sampling.sample_planeline_prod_sum
    _, full = _density_grads(fn, planes, lines, coords, live, cot,
                             (True,) * 9)
    cuda_build.reset_launches()
    _, frozen = _density_grads(fn, planes, lines, coords, live, cot,
                               (False,) * 6 + (True,) * 3)
    assert cuda_build.LAUNCHES["density_sample_bwd"] == 1
    for a, b in zip(frozen[6:], full[6:]):
        assert torch.equal(a, b)
    cuda_build.reset_launches()
    _, detached = _density_grads(fn, planes, lines, coords, live, cot,
                                 (True,) * 6 + (False,) * 3)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["density_sample_bwd"] == 1
    for a, b in zip(detached[:6], full[:6]):
        _close(a, b)
    # the kernel's own entry point: no output asked for, no output made
    from joint_tensorf_tpu_torch.models import vm
    from joint_tensorf_tpu_torch.ops import density_sample

    d_p, d_l, d_c = density_sample.density_sample_bwd_cuda(
        planes, lines, coords, vm.AXES, live, cot,
        (False,) * 6 + (True, False, True))
    assert d_p == [None] * 3 and d_l == [None] * 3 and d_c[1] is None
    assert torch.equal(d_c[0], full[6]) and torch.equal(d_c[2], full[8])


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
    from joint_tensorf_tpu_torch.models import vm
    from joint_tensorf_tpu_torch.ops import density_sample

    planes = [torch.zeros((5, 5, 4), device="cuda")] * 3
    lines = [torch.zeros((5, 4), device="cuda")] * 3
    coords = [torch.zeros(7, device="cuda")] * 3
    with pytest.raises(TypeError):
        density_sample.density_sample_fwd_cuda(
            [p.double() for p in planes], lines, coords, vm.AXES)
    with pytest.raises(ValueError):
        density_sample.density_sample_fwd_cuda(
            planes, lines, coords, vm.AXES,
            torch.ones(7, dtype=torch.uint8, device="cuda"))
    with pytest.raises(ValueError):
        density_sample.density_sample_fwd_cuda(
            planes, [torch.zeros((5, 3), device="cuda")] * 3, coords,
            vm.AXES)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_one_rank():
    """One sharded BAT step on 2 gloo ranks sharing cuda:0
    (parallel.launch.spawn) against the unsharded step on the card from
    the same state and draws: loss at rtol 1e-4, gradients within 1e-3 of
    each leaf's max (the card-vs-CPU gate), the two ranks' states equal
    bit for bit, one gradient all-reduce and K1-K3 launched on each."""
    _ranks_on_the_card_match_one_rank([2], ["rays"],
                                      {"grads": 1, "nan_counts": 1})


@pytest.mark.cuda
def test_comp_gloo_ranks_on_the_card_match_one_rank():
    """The same step in the comp layout, [1, 2] over [rays, comp]: each
    rank holds half of every factor's components; the gathered states
    equal bit for bit; the comp group's forward, backward and basis
    reductions once each."""
    _ranks_on_the_card_match_one_rank(
        [1, 2], ["rays", "comp"],
        {"comp_forward": 1, "comp_backward": 1, "comp_grads": 1})


@pytest.mark.cuda
def test_comp_gloo_ranks_with_the_summed_density_sample():
    """The comp layout's step with the two-stage appearance: each rank's
    density is K6 on its block of components (2 of 4 a factor: the
    scalar route), summed over the comp group; as the test above, with a
    forward and a backward reduction for each of the density and the
    appearance."""
    _ranks_on_the_card_match_one_rank(
        [1, 2], ["rays", "comp"],
        {"comp_forward": 2, "comp_backward": 2, "comp_grads": 1}, app_k=16)


def _ranks_on_the_card_match_one_rank(mesh_shape, mesh_axes, counts,
                                      **step_extra):
    _need_card()
    import numpy as np

    from joint_tensorf_tpu_torch import convert
    from joint_tensorf_tpu_torch.data.synthetic import sphere_poses
    from joint_tensorf_tpu_torch.models import vm as vm_lib
    from joint_tensorf_tpu_torch.parallel.launch import run_jobs, spawn
    from joint_tensorf_tpu_torch.render.renderer import BlurSpec
    from joint_tensorf_tpu_torch.train import step as pstep

    V, H, W, R = 3, 32, 32, 64
    vm = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12,
              hidden=16)
    cfg = vm_lib.VMConfig(**vm)
    gen = torch.Generator(device="cuda").manual_seed(0)
    field = vm_lib.init_vm(cfg, (24, 24, 24), np.array(
        [[-1.5] * 3, [1.5] * 3], np.float32), gen, device="cuda")
    state = convert.to_numpy(pstep.init_train_state(field, V))
    rng = np.random.default_rng(0)
    focal = 1.1 * W
    intr = np.broadcast_to(np.array(
        [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32),
        (V, 3, 3)).copy()
    x = dict(pose_base=sphere_poses(V).astype(np.float32), intr=intr,
             intr_inv=np.linalg.inv(intr).astype(np.float32),
             images=rng.random((V, H * W, 3)).astype(np.float32),
             edges=(rng.random((V, H * W)) > 0.7).astype(np.float32),
             view_sel=np.arange(V), ray_idx=rng.permutation(H * W)[:R],
             jitter=rng.random((V * R, 1)).astype(np.float32))
    state["pose_base"] = x["pose_base"]
    step_cfg = dict(H=H, W=W, n_views=V, rays_per_view=R, n_samples=64,
                    blur=BlurSpec("uniform-gaussian", 8), **step_extra)
    sc = dict(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3, c2f_density=0.1,
              c2f_color=0.25, l1_weight=8e-5, use_edge=1.0, edge_factor=1.5,
              non_edge_factor=0.5)
    st, pose_base = convert.train_state_from_numpy(state, cfg, device="cuda")
    t = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    m1, g1 = pstep.train_step(
        st, pstep.StepConfig(**step_cfg), cfg, pose_base, t["intr_inv"],
        t["images"], t["edges"], t["view_sel"], t["ray_idx"],
        pstep.StepScalars(**sc), jitter=t["jitter"])
    out = spawn(run_jobs, 2, {"mesh_shape": mesh_shape,
                              "mesh_axes": mesh_axes, "jobs": [dict(
                                  kind="step", vm_cfg=vm, step_cfg=step_cfg,
                                  scalars=sc, state=state, inputs=x)]},
                backend="gloo", device="cuda:0", timeout_s=300)
    res = out[0][0]
    torch.testing.assert_close(res["metrics"]["loss"], float(m1["loss"]),
                               rtol=1e-4, atol=0)
    for k, g in g1.items():
        g = g.cpu().numpy()
        err = np.abs(res["grads"][k] - g).max() / max(np.abs(g).max(), 1e-30)
        assert err <= 1e-3, (k, err)
    from joint_tensorf_tpu_torch.utils.tree import flatten

    a, b = flatten(out[0][0]["state"]), flatten(out[1][0]["state"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for r in out:
        assert r[0]["counts"] == counts
        launched = r[0]["launches"]
        assert launched["composite_fwd"] == launched["composite_bwd"] == 1
        assert launched["scatter_add_rows"] > 0
        k6 = int(step_extra.get("app_k") is not None)
        assert launched["density_sample_fwd"] == k6
        assert launched["density_sample_bwd"] == k6
