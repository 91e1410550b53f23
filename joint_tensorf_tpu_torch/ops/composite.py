"""Volume compositing: kernels K1 (forward) and K2 (backward) and their
plain versions (counterpart of joint_tensorf_tpu/ops/composite.py together
with joint_tensorf_tpu/ops/pallas_kernels.py).

    composite(alpha, rgb, z, thres) -> (rgb_map [N,3], depth [N], acc [N], weights [N,S])

    u_i = 1 - alpha_i + 1e-10,  T_i = prod_{j<i} u_j,  w_i = alpha_i T_i
    rgb_map = sum_i w_i rgb_i [w_i > thres],  depth = sum_i w_i z_i,  acc = sum_i w_i

The gate is the renderer's appearance gate (weight > raymarch threshold,
joint_tensorf_tpu/render/renderer.py:613/630) folded in; ``thres=-inf``
gives the ungated compositor of the Pallas kernel.  The backward is the
division-free recurrence of the reference (ops/composite.py:50-74), so
rays with alpha == 1.0 exactly keep finite gradients.  It takes the
forward's weights (as B2 takes ``weights_ref``): its gate is the forward's
``weights > thres`` exactly, and d_rgb / d_z use those weights.

On CUDA tensors the autograd function launches the kernels of
csrc/composite.cu; on CPU tensors it runs the plain versions below, which
compute the same recurrence in torch ops.  There is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

EPS = 1e-10

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P, _P, _P, ctypes.c_float, _P, _P, _P, _P,
                 ctypes.c_int, ctypes.c_int, _P]
_BWD_ARGTYPES = [_P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P, _P,
                 _P, ctypes.c_int, ctypes.c_int, _P]


# ------------------------------------------------------------ plain versions
def _transmittance(alpha):
    """(u, exclusive running product T, w)."""
    u = 1.0 - alpha + EPS
    T_incl = torch.cumprod(u, dim=-1)
    T = torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]], dim=-1)
    return u, T, alpha * T


def composite_fwd_plain(alpha, rgb, z, thres: float):
    _, _, w = _transmittance(alpha)
    gate = (w > thres).to(w.dtype)
    rgb_map = torch.sum(w[..., None] * (rgb * gate[..., None]), dim=-2)
    depth = torch.sum(w * z, dim=-1)
    acc = torch.sum(w, dim=-1)
    return rgb_map, depth, acc, w


def _suffix_recurrence(c, a):
    """B_j = c_j + a_j B_{j+1} along the last axis with B_S = 0, as a
    log-depth (Hillis-Steele) scan over composed affine maps."""
    c = torch.flip(c, dims=(-1,))
    a = torch.flip(a, dims=(-1,))
    S = c.shape[-1]
    d = 1
    while d < S:
        c_new = c.clone()
        a_new = a.clone()
        c_new[:, d:] = c[:, d:] + a[:, d:] * c[:, :-d]
        a_new[:, d:] = a[:, d:] * a[:, :-d]
        c, a = c_new, a_new
        d *= 2
    return torch.flip(c, dims=(-1,))


def composite_bwd_plain(alpha, rgb, z, weights, thres: float, g_rgb,
                        g_depth, g_acc, g_weights):
    """g_weights may be None: no gradient reaches the weights."""
    u, T, _ = _transmittance(alpha)
    w = weights
    gate = (w > thres).to(w.dtype)
    g_w = (gate * torch.sum(g_rgb[:, None, :] * rgb, dim=-1)
           + g_depth[:, None] * z + g_acc[:, None])
    if g_weights is not None:
        g_w = g_w + g_weights
    # B_i = g_w_{i+1} alpha_{i+1} + u_{i+1} B_{i+1}, B_{S-1} = 0
    cw = g_w * alpha
    c = torch.cat([cw[:, 1:], torch.zeros_like(cw[:, :1])], dim=-1)
    a = torch.cat([u[:, 1:], torch.ones_like(u[:, :1])], dim=-1)
    B = _suffix_recurrence(c, a)
    d_alpha = T * (g_w - B)
    d_rgb = g_rgb[:, None, :] * (w * gate)[..., None]
    d_z = g_depth[:, None] * w
    return d_alpha, d_rgb, d_z


# ------------------------------------------------------------- CUDA kernels
def _check_inputs(name, alpha, rgb, z, *more):
    dev = alpha.device
    for t in (alpha, rgb, z) + more:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    N, S = alpha.shape
    if rgb.shape != (N, S, 3) or z.shape != (N, S):
        raise ValueError(f"{name}: bad shapes alpha {tuple(alpha.shape)}, "
                         f"rgb {tuple(rgb.shape)}, z {tuple(z.shape)}")
    return N, S


def composite_fwd_cuda(alpha, rgb, z, thres: float):
    """Launch K1 -> (rgb_map [N,3], depth [N], acc [N], weights [N,S])."""
    N, S = _check_inputs("composite_fwd_cuda", alpha, rgb, z)
    new = dict(dtype=torch.float32, device=alpha.device)
    rgb_map = torch.empty((N, 3), **new)
    depth = torch.empty((N,), **new)
    acc = torch.empty((N,), **new)
    weights = torch.empty((N, S), **new)
    fn = cuda_build.kernel("composite", "composite_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(alpha.data_ptr(), rgb.data_ptr(), z.data_ptr(), thres,
                 rgb_map.data_ptr(), depth.data_ptr(), acc.data_ptr(),
                 weights.data_ptr(), N, S, stream)
    cuda_build.LAUNCHES["composite_fwd"] += 1
    cuda_build.check(err, "composite_fwd")
    return rgb_map, depth, acc, weights


def composite_bwd_cuda(alpha, rgb, z, weights, thres: float, g_rgb,
                       g_depth, g_acc, g_weights):
    """Launch K2 -> (d_alpha [N,S], d_rgb [N,S,3], d_z [N,S]); weights
    [N,S] are the forward's; g_weights may be None (not read)."""
    more = (weights, g_rgb, g_depth, g_acc) + (
        () if g_weights is None else (g_weights,))
    N, S = _check_inputs("composite_bwd_cuda", alpha, rgb, z, *more)
    if weights.shape != (N, S) or g_rgb.shape != (N, 3) or \
            g_depth.shape != (N,) or g_acc.shape != (N,) or \
            (g_weights is not None and g_weights.shape != (N, S)):
        raise ValueError("composite_bwd_cuda: bad cotangent shapes")
    new = dict(dtype=torch.float32, device=alpha.device)
    d_alpha = torch.empty((N, S), **new)
    d_rgb = torch.empty((N, S, 3), **new)
    d_z = torch.empty((N, S), **new)
    fn = cuda_build.kernel("composite", "composite_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(alpha.data_ptr(), rgb.data_ptr(), z.data_ptr(),
                 weights.data_ptr(), thres,
                 g_rgb.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(),
                 None if g_weights is None else g_weights.data_ptr(),
                 d_alpha.data_ptr(), d_rgb.data_ptr(),
                 d_z.data_ptr(), N, S, stream)
    cuda_build.LAUNCHES["composite_bwd"] += 1
    cuda_build.check(err, "composite_bwd")
    return d_alpha, d_rgb, d_z


def _dispatch(cuda_fn, plain_fn, x):
    if x.is_cuda:
        return cuda_fn
    if x.device.type != "cpu":
        raise ValueError(f"composite: no kernel for {x.device}")
    return plain_fn


class Composite(torch.autograd.Function):
    """K1 forward / K2 backward on CUDA; the plain versions on the CPU.

    Gradients of unused outputs arrive as None, not as zeros: the training
    step never uses the weights, so their [N, S] zero cotangent is neither
    made nor read."""

    @staticmethod
    def forward(ctx, alpha, rgb, z, thres: float):
        alpha, rgb, z = alpha.contiguous(), rgb.contiguous(), z.contiguous()
        fwd = _dispatch(composite_fwd_cuda, composite_fwd_plain, alpha)
        out = fwd(alpha, rgb, z, float(thres))
        ctx.save_for_backward(alpha, rgb, z, out[3])
        ctx.thres = float(thres)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc, g_weights):
        alpha, rgb, z, weights = ctx.saved_tensors
        N = alpha.shape[0]

        def cot(g, shape):
            return alpha.new_zeros(shape) if g is None else g.contiguous()

        bwd = _dispatch(composite_bwd_cuda, composite_bwd_plain, alpha)
        d_alpha, d_rgb, d_z = bwd(
            alpha, rgb, z, weights, ctx.thres, cot(g_rgb, (N, 3)),
            cot(g_depth, (N,)), cot(g_acc, (N,)),
            None if g_weights is None else g_weights.contiguous())
        return d_alpha, d_rgb, d_z, None


def composite(alpha, rgb, z, thres: float = float("-inf")):
    """alpha, z: [N,S]; rgb: [N,S,3] ->
    (rgb_map [N,3], depth [N], acc [N], weights [N,S])."""
    return Composite.apply(alpha, rgb, z, thres)
