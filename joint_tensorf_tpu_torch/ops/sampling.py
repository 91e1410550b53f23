"""Factor-grid sampling: the plain plane / line / 3D-grid samples
(counterpart of joint_tensorf_tpu/ops/sampling.py:33-113 and :466-504),
the hybrid samples (:116-194) and the fused plane x line factor sample
with its hand-written backward (:219-426).

    sample_plane(plane [H,W,R], u, v [N]) -> [N,R]    one packed gather,
        index_add_ backward (K4's plain version, convolve_positive_only);
        JAX's sample_plane_packed, the same values bit for bit
    sample_line(line [D,R], w [N]) -> [N,R]    one packed gather, one
        row-scatter backward (K3 on a CUDA tensor; CP's lines,
        convolve_positive_only); JAX's sample_line_packed
    sample_plane_hybrid(plane, u, v) / sample_line_hybrid(line, w)
        the 4-corner or 2-point gather forward; the backward ONE row
        scatter of [N, 4R] or [N, 2R] (K3 on a CUDA tensor), folded
    sample_grid3d(grid [X,Y,Z], (x, y, z) [N]) -> [N]    trilinear (alpha mask)
    sample_planeline_prod(plane [H,W,R], line [D,R], u, v, w [N]) -> p(u,v) * l(w)  [N,R]
        its backward in chunks of at most _PROD_BWD_CHUNK samples, as
        JAX's _prod_bwd: per chunk one [ck, 4R] plane and one [ck, 2R]
        line row scatter (K3 on a CUDA tensor), folded once at the end
    sample_planeline_prod_sum(planes, lines, coords, axes, live) -> [N]
        the VM density feature: sample_planeline_prod summed over R and
        the three axes, 0 where ``live`` is False; kernel K6 forward and
        backward on a CUDA tensor (ops/density_sample.py), which works on
        the live slots alone; the plain version on a CPU tensor

Bilinear plane / linear line sampling with align_corners semantics,
channels-last, clamped to the border as jnp.clip clamps (_pix), so a
coordinate exactly on the border gets half the gradient there.  The
backwards return those of their gradients that autograd asks for
(ctx.needs_input_grad): the factor gradients (corner-packed row scatters
into the plane and the line, folded densely) and the coordinate gradients,
which are the path pose gradients take: the fused sample's with the
border masks of its reference VJP, the hybrids' and the binned sample's
those of autograd through the plain gather with the factor held constant,
as JAX's jax.vjp of the plain gather gives them.

Forward and backward are plain PyTorch, except the row scatters that go
through ops/segment_scatter.scatter_add_rows: kernel K3 on a CUDA tensor,
``index_add_`` on a CPU tensor; and the summed density sample, which is
K6 on a CUDA tensor (its plain version's row scatters are ``index_add_``,
never K3).

The planar pipeline's image sample (:428-463) is here too:

    sample_image(img [C,H,W], coords [N,2]) -> [N,C]    grid_sample's
        align_corners=False with zero padding (or nearest), in JAX's
        gather form; autograd through the gathers and the fractions
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import density_sample
from .segment_scatter import scatter_add_rows


def _pix(coord, size: int):
    """Normalized [-1,1] -> continuous pixel index [0, size-1] (align
    corners), clamped as jnp.clip clamps (maximum, then minimum): a
    coordinate exactly on a face gets half the gradient, as JAX's autodiff
    of the samplers gives (torch.clamp would give all of it)."""
    x = (coord + 1.0) * 0.5 * (size - 1)
    return torch.minimum(torch.maximum(x, x.new_zeros(())),
                         x.new_full((), size - 1.0))


def _floor_frac(x, size: int):
    x0 = torch.clamp(torch.floor(x.detach()), 0, size - 2 if size > 1 else 0)
    return x0.long(), x - x0


class _GatherRows(torch.autograd.Function):
    """table[idx] whose backward scatters the rows' cotangent with
    ``scatter(idx, g, n_rows)``: torch's own gather backward (index_put_
    with accumulate, which sorts the indices) serialises the many samples
    that share a row."""

    @staticmethod
    def forward(ctx, table, idx, scatter):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.scatter = table.shape[0], scatter
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        idx, = ctx.saved_tensors
        return ctx.scatter(idx, g.contiguous(), ctx.n_rows), None, None


def _coord_vjp(sample, table, coords, g):
    """The coordinates' cotangents of ``sample(table, *coords)`` with the
    table held constant (JAX's jax.vjp of the gather-only closure)."""
    with torch.enable_grad():
        cs = [c.detach().requires_grad_(True) for c in coords]
        return torch.autograd.grad(sample(table.detach(), *cs), cs, g)


def _index_add_rows(idx, updates, n_rows: int):
    return torch.zeros((n_rows, updates.shape[1]), dtype=updates.dtype,
                       device=updates.device).index_add_(0, idx, updates)


def sample_line(line, w):
    """line [D, R]; w [N] normalized coord along the line axis -> [N, R]:
    one packed row gather (the JAX package's sample_line_packed, the
    same values as sampling both neighbours), its backward one [N, 2R] row
    scatter (K3 on a CUDA tensor; jnp.take's VJP is a scatter too),
    autograd through the fraction."""
    D, R = line.shape
    i0, fx = _floor_frac(_pix(w, D), D)
    rows = _GatherRows.apply(pack_line(line), i0, scatter_add_rows)
    return rows[:, :R] * (1.0 - fx)[:, None] + rows[:, R:] * fx[:, None]


def sample_plane(plane, u, v):
    """plane [H, W, R]; u (->W axis), v (->H axis) [N] in [-1,1] -> [N, R]:
    one corner-packed row gather (the JAX package's sample_plane_packed,
    the same values as gathering the four corners), its backward one
    ``index_add_`` of the [N, 4R] rows (plain torch, not K3); autograd
    through the fractions."""
    H, W, R = plane.shape
    x0, fx = _floor_frac(_pix(u, W), W)
    y0, fy = _floor_frac(_pix(v, H), H)
    rows = _GatherRows.apply(pack_plane(plane).reshape(H * W, 4 * R),
                             y0 * W + x0, _index_add_rows)
    w00, w01, w10, w11 = _bilinear_weights(fx, fy)
    return (rows[:, :R] * w00 + rows[:, R:2 * R] * w01
            + rows[:, 2 * R:3 * R] * w10 + rows[:, 3 * R:] * w11)


sample_line_packed = sample_line
sample_plane_packed = sample_plane


def _corner_sample(plane, u, v):
    """sample_plane as four corner gathers (the forward reads each corner
    once, not the 4x-wide packed rows)."""
    H, W, R = plane.shape
    x0, fx = _floor_frac(_pix(u, W), W)
    y0, fy = _floor_frac(_pix(v, H), H)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = plane.reshape(H * W, R)
    w00, w01, w10, w11 = _bilinear_weights(fx, fy)
    return (flat[y0 * W + x0] * w00 + flat[y0 * W + x1] * w01
            + flat[y1 * W + x0] * w10 + flat[y1 * W + x1] * w11)


def _point_sample(line, w):
    """sample_line as two point gathers."""
    D = line.shape[0]
    i0, fx = _floor_frac(_pix(w, D), D)
    i1 = torch.clamp(i0 + 1, max=D - 1)
    return line[i0] * (1.0 - fx)[:, None] + line[i1] * fx[:, None]


class SamplePlaneHybrid(torch.autograd.Function):
    """4-corner gather forward; the plane's gradient ONE [N, 4R] row
    scatter (K3 on the card) into the packed layout, folded densely."""

    @staticmethod
    def forward(ctx, plane, u, v):
        ctx.save_for_backward(plane, u, v)
        return _corner_sample(plane, u, v)

    @staticmethod
    def backward(ctx, g):
        plane, u, v = ctx.saved_tensors
        H, W, R = plane.shape
        g = g.contiguous()
        d_plane = d_u = d_v = None
        if ctx.needs_input_grad[0]:
            x0, fx = _floor_frac(_pix(u.detach(), W), W)
            y0, fy = _floor_frac(_pix(v.detach(), H), H)
            g4 = torch.cat([g * w for w in _bilinear_weights(fx, fy)], -1)
            d_plane = _plane_fold(scatter_add_rows(y0 * W + x0, g4, H * W),
                                  H, W, R).to(plane.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_u, d_v = _coord_vjp(_corner_sample, plane, (u, v), g)
        return d_plane, d_u, d_v


class SampleLineHybrid(torch.autograd.Function):
    """2-point gather forward; the line's gradient ONE [N, 2R] row scatter
    (K3 on the card) into the packed layout, folded."""

    @staticmethod
    def forward(ctx, line, w):
        ctx.save_for_backward(line, w)
        return _point_sample(line, w)

    @staticmethod
    def backward(ctx, g):
        line, w = ctx.saved_tensors
        D, R = line.shape
        g = g.contiguous()
        d_line = d_w = None
        if ctx.needs_input_grad[0]:
            i0, fx = _floor_frac(_pix(w.detach(), D), D)
            g2 = torch.cat([g * (1.0 - fx)[:, None], g * fx[:, None]], -1)
            d_line = _line_fold(scatter_add_rows(i0, g2, D), D, R).to(
                line.dtype)
        if ctx.needs_input_grad[1]:
            d_w, = _coord_vjp(_point_sample, line, (w,), g)
        return d_line, d_w


def sample_plane_hybrid(plane, u, v):
    """sample_plane's function: plane [H,W,R], u (->W), v (->H) [N] ->
    [N,R], with the hybrid backward."""
    return SamplePlaneHybrid.apply(plane, u, v)


def sample_line_hybrid(line, w):
    """sample_line's function: line [D,R], w [N] -> [N,R], with the
    hybrid backward."""
    return SampleLineHybrid.apply(line, w)


def sample_grid3d(grid, x, y, z):
    """Trilinear sample of a dense [X, Y, Z] grid at per-axis normalized
    coords x, y, z [N] in [-1,1] -> [N] (the alpha mask's lookup)."""
    X, Y, Z = grid.shape
    x0, fx = _floor_frac(_pix(x, X), X)
    y0, fy = _floor_frac(_pix(y, Y), Y)
    z0, fz = _floor_frac(_pix(z, Z), Z)
    x1 = torch.clamp(x0 + 1, max=X - 1)
    y1 = torch.clamp(y0 + 1, max=Y - 1)
    z1 = torch.clamp(z0 + 1, max=Z - 1)
    flat = grid.reshape(-1)

    def gat(xi, yi, zi):
        return flat[(xi * Y + yi) * Z + zi]

    c00 = gat(x0, y0, z0) * (1 - fz) + gat(x0, y0, z1) * fz
    c01 = gat(x0, y1, z0) * (1 - fz) + gat(x0, y1, z1) * fz
    c10 = gat(x1, y0, z0) * (1 - fz) + gat(x1, y0, z1) * fz
    c11 = gat(x1, y1, z0) * (1 - fz) + gat(x1, y1, z1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def pack_plane(plane):
    """[H, W, R] -> [H, W, 4R]: (self, x+1, y+1, x+1&y+1), edge-clamped."""
    px = torch.cat([plane[:, 1:], plane[:, -1:]], dim=1)
    py = torch.cat([plane[1:], plane[-1:]], dim=0)
    pxy = torch.cat([py[:, 1:], py[:, -1:]], dim=1)
    return torch.cat([plane, px, py, pxy], dim=-1)


def pack_line(line):
    """[D, R] -> [D, 2R]: (self, next), edge-clamped."""
    nxt = torch.cat([line[1:], line[-1:]], dim=0)
    return torch.cat([line, nxt], dim=-1)


def _plane_fold(d_packed, H: int, W: int, R: int):
    """Transpose of pack_plane's clamped shifts: [H*W, 4R] -> [H, W, R]."""
    dp = d_packed.reshape(H, W, 4 * R)
    d_plane = dp[..., :R].clone()
    dx = dp[..., R:2 * R]
    d_plane[:, 1:] += dx[:, :-1]
    d_plane[:, -1] += dx[:, -1]
    dy = dp[..., 2 * R:3 * R]
    d_plane[1:] += dy[:-1]
    d_plane[-1] += dy[-1]
    dxy = dp[..., 3 * R:]
    dxy_s = F.pad(dxy[:, :-1], (0, 0, 1, 0))
    dxy_s[:, -1] += dxy[:, -1]
    d_plane[1:] += dxy_s[:-1]
    d_plane[-1] += dxy_s[-1]
    return d_plane


def _line_fold(d_packed, D: int, R: int):
    """Transpose of pack_line's clamped shift: [D, 2R] -> [D, R]."""
    d_line = d_packed[:, :R].clone()
    dn = d_packed[:, R:]
    d_line[1:] += dn[:-1]
    d_line[-1] += dn[-1]
    return d_line


def _bilinear_weights(fx, fy):
    return (((1 - fy) * (1 - fx))[:, None], ((1 - fy) * fx)[:, None],
            (fy * (1 - fx))[:, None], (fy * fx)[:, None])


# The backward's transients ([chunk, 4R] plane rows, [chunk, 2R] line rows
# and their updates) are bounded by chunks of at most this many samples,
# as JAX's _prod_bwd bounds them (joint_tensorf_tpu/ops/sampling.py:249-256);
# the factor gradients accumulate over the chunks.
_PROD_BWD_CHUNK = 1 << 20


def _prod_chunk_grads(packed_plane, packed_line, shape, u, v, w, g, need):
    """JAX's chunk_grads on one chunk of samples, only what ``need``
    (plane, line, u, v, w) asks for: (plane row index [ck], plane updates
    [ck, 4R], line row index [ck], line updates [ck, 2R], d_u, d_v, d_w
    [ck]), None where not asked."""
    H, W, D, R = shape
    need_p, need_l, need_u, need_v, need_w = need
    x_raw = (u + 1.0) * 0.5 * (W - 1)
    y_raw = (v + 1.0) * 0.5 * (H - 1)
    z_raw = (w + 1.0) * 0.5 * (D - 1)
    x0, fx = _floor_frac(torch.clamp(x_raw, 0.0, W - 1.0), W)
    y0, fy = _floor_frac(torch.clamp(y_raw, 0.0, H - 1.0), H)
    i0, fz = _floor_frac(torch.clamp(z_raw, 0.0, D - 1.0), D)
    idx = y0 * W + x0
    rows = packed_plane[idx]                                  # [ck, 4R]
    f00, f01, f10, f11 = (rows[:, :R], rows[:, R:2 * R],
                          rows[:, 2 * R:3 * R], rows[:, 3 * R:])
    lrows = packed_line[i0]                                   # [ck, 2R]
    l0, l1 = lrows[:, :R], lrows[:, R:]
    w00, w01, w10, w11 = _bilinear_weights(fx, fy)
    l = l0 * (1.0 - fz)[:, None] + l1 * fz[:, None]
    gl = g * l
    g4 = g2 = d_u = d_v = d_w = gp = None
    if need_p:
        g4 = torch.cat([gl * w00, gl * w01, gl * w10, gl * w11], -1)
    if need_l or need_w:
        gp = g * (f00 * w00 + f01 * w01 + f10 * w10 + f11 * w11)
    if need_l:
        g2 = torch.cat([gp * (1.0 - fz)[:, None], gp * fz[:, None]], -1)
    if need_u:
        dp_dx = (f01 - f00) * (1 - fy)[:, None] + (f11 - f10) * fy[:, None]
        mx = ((x_raw > 0) & (x_raw < W - 1)).to(g.dtype)
        d_u = torch.sum(gl * dp_dx, -1) * (0.5 * (W - 1)) * mx
    if need_v:
        dp_dy = (f10 - f00) * (1 - fx)[:, None] + (f11 - f01) * fx[:, None]
        my = ((y_raw > 0) & (y_raw < H - 1)).to(g.dtype)
        d_v = torch.sum(gl * dp_dy, -1) * (0.5 * (H - 1)) * my
    if need_w:
        mz = ((z_raw > 0) & (z_raw < D - 1)).to(g.dtype)
        d_w = torch.sum(gp * (l1 - l0), -1) * (0.5 * (D - 1)) * mz
    return idx, g4, i0, g2, d_u, d_v, d_w


class SamplePlaneLineProd(torch.autograd.Function):
    """p(u, v) * l(w); ``scatter`` (None: scatter_add_rows) takes the
    backward's row scatters."""

    @staticmethod
    def forward(ctx, plane, line, u, v, w, scatter=None):
        H, W, R = plane.shape
        D = line.shape[0]
        x0, fx = _floor_frac(_pix(u, W), W)
        y0, fy = _floor_frac(_pix(v, H), H)
        i0, fz = _floor_frac(_pix(w, D), D)
        rows = pack_plane(plane).reshape(H * W, 4 * R)[y0 * W + x0]
        w00, w01, w10, w11 = _bilinear_weights(fx, fy)
        p = (rows[:, :R] * w00 + rows[:, R:2 * R] * w01
             + rows[:, 2 * R:3 * R] * w10 + rows[:, 3 * R:] * w11)
        lrows = pack_line(line)[i0]
        l = lrows[:, :R] * (1.0 - fz)[:, None] + lrows[:, R:] * fz[:, None]
        ctx.save_for_backward(plane, line, u, v, w)
        ctx.scatter = scatter or scatter_add_rows
        return p * l

    @staticmethod
    def backward(ctx, g):
        """JAX's _prod_bwd: the N samples in chunks of at most
        _PROD_BWD_CHUNK (slices, so views: no padding), per chunk the
        plane's [ck, 4R] and the line's [ck, 2R] row scatters
        (scatter_add_rows: K3 on a CUDA tensor) summed into one packed
        gradient each, folded once.  Only the cotangents autograd asks
        for: with the factors frozen (test-time pose optimisation) no
        scatter runs, as JAX's value_and_grad w.r.t. the pose alone drops
        them."""
        plane, line, u, v, w = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        need_p, need_l, need_u, need_v, need_w = need
        H, W, R = plane.shape
        D = line.shape[0]
        N = u.shape[0]
        g = g.contiguous()
        packed_plane = pack_plane(plane).reshape(H * W, 4 * R)
        packed_line = pack_line(line)
        d_pk = d_lk = None
        d_u = torch.empty_like(u) if need_u else None
        d_v = torch.empty_like(v) if need_v else None
        d_w = torch.empty_like(w) if need_w else None
        ck = max(1, min(_PROD_BWD_CHUNK, N))
        for s in range(0, N, ck):
            e = min(s + ck, N)
            idx, g4, i0, g2, du, dv, dw = _prod_chunk_grads(
                packed_plane, packed_line, (H, W, D, R), u[s:e], v[s:e],
                w[s:e], g[s:e], need)
            if need_p:
                part = ctx.scatter(idx, g4, H * W)
                d_pk = part if d_pk is None else d_pk.add_(part)
            if need_l:
                part = ctx.scatter(i0, g2, D)
                d_lk = part if d_lk is None else d_lk.add_(part)
            for full, part in ((d_u, du), (d_v, dv), (d_w, dw)):
                if full is not None:
                    full[s:e] = part
        d_plane = None if d_pk is None else _plane_fold(d_pk, H, W, R)
        d_line = None if d_lk is None else _line_fold(d_lk, D, R)
        return d_plane, d_line, d_u, d_v, d_w, None


def sample_planeline_prod(plane, line, u, v, w):
    """p(u,v) * l(w): plane [H,W,R], line [D,R], u (->W), v (->H),
    w (->D) [N] in [-1,1] -> [N,R]."""
    return SamplePlaneLineProd.apply(plane, line, u, v, w)


class SamplePlaneLineProdSum(torch.autograd.Function):
    """sample_planeline_prod_sum on the card: K6's forward, and its
    backward for the gradients autograd asks for (frozen factors: none
    into the factors; detached coordinates: none for them)."""

    @staticmethod
    def forward(ctx, axes, live, p0, p1, p2, l0, l1, l2, x, y, z):
        planes = tuple(t.contiguous() for t in (p0, p1, p2))
        lines = tuple(t.contiguous() for t in (l0, l1, l2))
        coords = tuple(t.contiguous() for t in (x, y, z))
        live = None if live is None else live.contiguous()
        ctx.axes = axes
        ctx.save_for_backward(live, *planes, *lines, *coords)
        return density_sample.density_sample_fwd_cuda(planes, lines, coords,
                                                      axes, live)

    @staticmethod
    def backward(ctx, g):
        live, *factors = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        if not any(need):
            return (None,) * 11
        d_planes, d_lines, d_coords = density_sample.density_sample_bwd_cuda(
            factors[0:3], factors[3:6], factors[6:9], ctx.axes, live,
            g.contiguous(), need)
        return (None, None, *d_planes, *d_lines, *d_coords)


def sample_planeline_prod_sum_plain(planes, lines, coords, axes, live=None):
    """K6's plain version (any device): the sum over R and the axes of
    sample_planeline_prod(planes[a], lines[a], *coords[axes[a]]), then 0
    where ``live`` is False.  Its row scatters are ``index_add_``
    (_index_add_rows): this is the plain version of K6, not a K3 call."""
    sigma = torch.zeros_like(coords[0])
    for plane, line, (a, b, c) in zip(planes, lines, axes):
        prod = SamplePlaneLineProd.apply(plane, line, coords[a], coords[b],
                                         coords[c], _index_add_rows)
        sigma = sigma + torch.sum(prod, dim=-1)
    if live is None:
        return sigma
    return torch.where(live, sigma, torch.zeros_like(sigma))


def sample_planeline_prod_sum(planes, lines, coords, axes, live=None):
    """sum_a sum_r planes[a](u, v)[r] * lines[a](w)[r] -> [N], with (u, v,
    w) = coords[axes[a]] (u -> W, v -> H, w -> D of the factors), 0 where
    ``live`` [N] bool is False (None: every slot live).  Three float32
    planes [H,W,R_a], lines [D,R_a] and coordinates [N].  K6 on a CUDA
    tensor, which reads only the live slots' factor rows and adds
    gradients only from them; the plain version on a CPU tensor."""
    if coords[0].is_cuda:
        return SamplePlaneLineProdSum.apply(axes, live, *planes, *lines,
                                            *coords)
    if coords[0].device.type != "cpu":
        raise ValueError(f"sample_planeline_prod_sum: no kernel for "
                         f"{coords[0].device}")
    return sample_planeline_prod_sum_plain(planes, lines, coords, axes, live)


def sample_image(img, coords, mode: str = "bilinear"):
    """grid_sample(align_corners=False, padding=zeros) of ``img`` [C, H, W]
    at ``coords`` [N, 2] (x, y in [-1, 1]) -> [N, C]; ``mode`` "nearest"
    rounds half to even, as jnp.round.  The floor is taken on the detached
    coordinate, so the coordinates' gradient flows through the fractions
    alone (F.grid_sample rounds its pixel coordinates differently)."""
    C, H, W = img.shape
    x = (coords[:, 0] + 1.0) * W / 2.0 - 0.5
    y = (coords[:, 1] + 1.0) * H / 2.0 - 0.5
    flat = img.reshape(C, H * W)

    def corner(xi, yi, w=None):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        vals = flat[:, idx].T                                  # [N, C]
        return vals * (inb if w is None else w * inb)[:, None]

    if mode == "nearest":
        return corner(torch.round(x).long(), torch.round(y).long())
    x0f = torch.floor(x.detach())
    y0f = torch.floor(y.detach())
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    return (corner(x0, y0, (1 - fx) * (1 - fy))
            + corner(x0 + 1, y0, fx * (1 - fy))
            + corner(x0, y0 + 1, (1 - fx) * fy)
            + corner(x0 + 1, y0 + 1, fx * fy))
