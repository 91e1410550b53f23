"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA card: every test skips without one (a CUDA kernel has no
CPU mode; the plain versions are held against JAX by the other
tests/test_torch_*.py files).  This file imports no JAX, so on a machine
with a card and without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: the compositor at rtol 1e-4 / atol 1e-5 (the kernel's chunked
prefix product rounds differently from the sequential cumprod; a weight
within an ulp of the gate threshold may flip its gate, which moves rgb_map
by at most thres); the row scatter K3 at rtol 1e-5 / atol 1e-4, the
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
    got_b = C.composite_bwd_cuda(alpha, rgb, z, thres, *cots)
    want_b = C.composite_bwd_plain(alpha, rgb, z, thres, *cots)
    torch.cuda.synchronize()
    for a, b in zip(list(got) + list(got_b), list(want) + list(want_b)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


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
