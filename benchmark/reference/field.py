"""Plain float32 PyTorch of BAT's VM field, after TensoRF (Chen et al.,
ECCV 2022, tensoRF.py) and BAT (Joint-TensoRF, bateRF.py): factor
sampling with F.grid_sample, the density and appearance features, the
shading heads, the coarse-to-fine factor blur as a 1-D convolution, the
align-corners upsample and the alpha-mask build.

Weights are laid out as the benchmark hands them to both sides: planes
[H = res[m1], W = res[m0], R] and lines [D = res[v], R] for the axis
pairs m = ((0, 1), (0, 2), (1, 2)) and lines v = (2, 1, 0), the basis
[3 Ra, app_dim], head layers w [fan_in, fan_out] and b [fan_out].
Departures from the published code, each the program's convention too:
the positional encoding lays out sin then cos per input channel
([..., D, 2F]; TensoRF lays out all sines then all cosines, a permutation
of the first layer's rows); factors start as |bias + scale N(0, 1)|.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MAT = ((0, 1), (0, 2), (1, 2))
VEC = (2, 1, 0)


# ------------------------------------------------------------ heads
def head_layers(kind: str, app_dim: int, view_pe: int, fea_pe: int,
                hidden: int) -> dict:
    """{layer name: (fan_in, fan_out)} of a shading head."""
    if kind == "MLP_Fea":
        fan_in = 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
        return {"layers.0": (fan_in, hidden), "layers.1": (hidden, hidden),
                "layers.2": (hidden, 3)}
    if kind == "MLP_Fea_WeakView":
        return {"layer1": ((2 * fea_pe + 1) * app_dim, hidden),
                "layer2": (hidden, hidden),
                "layer3": (hidden + 2 * view_pe * 3, 3)}
    raise NotImplementedError(f"reference head {kind!r}")


def encode(x, freqs: int):
    """[..., D] -> [..., D * 2F]: sin and cos of x * 2^l, l < F."""
    pts = x[..., None] * (2.0 ** torch.arange(freqs, dtype=x.dtype,
                                              device=x.device))
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1).reshape(
        x.shape[:-1] + (x.shape[-1] * 2 * freqs,))


def _linear(p, name, x):
    return x @ p[f"shading.{name}.w"] + p[f"shading.{name}.b"]


def head(kind: str, p: dict, viewdirs, feats, view_pe: int, fea_pe: int):
    """rgb [N, 3] of the head ``kind`` with parameters ``p``."""
    if kind == "MLP_Fea":
        x = torch.cat([feats, viewdirs, encode(feats, fea_pe),
                       encode(viewdirs, view_pe)], dim=-1)
        x = torch.relu(_linear(p, "layers.0", x))
        x = torch.relu(_linear(p, "layers.1", x))
        return torch.sigmoid(_linear(p, "layers.2", x))
    if kind == "MLP_Fea_WeakView":
        x = torch.cat([feats, encode(feats, fea_pe)], dim=-1)
        x = torch.relu(_linear(p, "layer1", x))
        x = torch.relu(_linear(p, "layer2", x))
        x = torch.cat([encode(viewdirs, view_pe), x], dim=-1)
        return torch.sigmoid(_linear(p, "layer3", x))
    raise NotImplementedError(f"reference head {kind!r}")


# ------------------------------------------------------------ sampling
def sample_plane(plane, u, v):
    """plane [H, W, R] at u (along W), v (along H) in [-1, 1] -> [N, R]:
    bilinear, align corners, clamped to the border."""
    grid = torch.stack([u, v], dim=-1).reshape(1, -1, 1, 2)
    out = F.grid_sample(plane.permute(2, 0, 1)[None], grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[0, :, :, 0].t()


def sample_line(line, w):
    """line [D, R] at w in [-1, 1] -> [N, R]: linear, align corners."""
    grid = torch.stack([torch.zeros_like(w), w], dim=-1).reshape(1, -1, 1, 2)
    out = F.grid_sample(line.t()[None, :, :, None], grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[0, :, :, 0].t()


def normalize(xyz, aabb):
    """World points [N, 3] -> [-1, 1] in the box [2, 3]."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def plane_line(planes, lines, c, i):
    m0, m1 = MAT[i]
    return (sample_plane(planes[i], c[:, m0], c[:, m1])
            * sample_line(lines[i], c[:, VEC[i]]))


def density_feature(f: dict, c):
    """Sum over axes and components of plane x line at normalized c."""
    return sum(plane_line(f["density_planes"], f["density_lines"], c,
                          i).sum(-1) for i in range(3))


def app_feature(f: dict, c, basis):
    return torch.cat([plane_line(f["app_planes"], f["app_lines"], c, i)
                      for i in range(3)], dim=-1) @ basis


def feature2density(feat, kind: str, shift: float):
    if kind == "relu":
        return torch.relu(feat + shift)
    return F.softplus(feat + shift)


# ------------------------------------------------------------ blur
def gaussian(t, kernel_size: int):
    """BAT's sampled Gaussian of sigma ``t`` (clamped at 1e-4), values
    clamped at 1, kernel_size // 2 * 2 + 1 taps."""
    t = max(float(t), 1e-4)
    n = torch.arange(-(kernel_size // 2), kernel_size // 2 + 1,
                     dtype=torch.float32)
    k = 1.0 / (t * math.sqrt(2 * math.pi)) * torch.exp(-0.5 * (n / t) ** 2)
    return torch.clamp(k, max=1.0)


def blur_along(x, kernel, dim: int):
    """'same' 1-D convolution of ``x`` along ``dim``, replicate padding."""
    k = kernel.to(x.device)
    half = k.numel() // 2
    moved = x.movedim(dim, -1)
    shape = moved.shape
    flat = moved.reshape(-1, 1, shape[-1])
    out = F.conv1d(F.pad(flat, (half, half), mode="replicate"),
                   k.flip(0)[None, None])
    return out.reshape(shape).movedim(-1, dim)


def blur_factors(planes, lines, kernel):
    return ([blur_along(blur_along(p, kernel, 0), kernel, 1)
             for p in planes], [blur_along(l, kernel, 0) for l in lines])


# ------------------------------------------------------------ transitions
@torch.no_grad()
def upsample(f: dict, res) -> dict:
    """Align-corners bilinear (planes) and linear (lines) resize of every
    factor to ``res`` (tensoRF.py upsample_VM)."""
    out = dict(f)
    for g in ("density", "app"):
        out[f"{g}_planes"] = [F.interpolate(
            p.permute(2, 0, 1)[None], size=(res[MAT[i][1]], res[MAT[i][0]]),
            mode="bilinear", align_corners=True)[0].permute(1, 2, 0)
            .contiguous() for i, p in enumerate(f[f"{g}_planes"])]
        out[f"{g}_lines"] = [F.interpolate(
            l.t()[None], size=res[VEC[i]], mode="linear",
            align_corners=True)[0].t().contiguous()
            for i, l in enumerate(f[f"{g}_lines"])]
    return out


@torch.no_grad()
def alpha_mask(f: dict, aabb, grid_res, step: float, thresh: float,
               fea2dense: str, shift: float, chunk: int = 1 << 21):
    """The alpha mask (tensorBase.py updateAlphaMask): opacity
    1 - exp(-sigma * step) at the grid points spanning the box, max-pooled
    over 5 cells, kept where >= ``thresh`` -> float grid [X, Y, Z]."""
    dev = aabb.device
    axes = [torch.linspace(0, 1, int(g), device=dev) for g in grid_res]
    s = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    xyz = aabb[0] * (1 - s) + aabb[1] * s
    alpha = torch.empty(xyz.shape[0], device=dev)
    for a in range(0, xyz.shape[0], chunk):
        sigma = feature2density(density_feature(
            f, normalize(xyz[a:a + chunk], aabb)), fea2dense, shift)
        alpha[a:a + chunk] = 1.0 - torch.exp(-sigma * step)
    alpha = alpha.reshape([int(g) for g in grid_res]).clamp(0, 1)
    pooled = F.max_pool3d(alpha[None, None], 5, stride=1, padding=2)[0, 0]
    return (pooled >= thresh).float()


def mask_alive(grid, aabb, xyz):
    """Trilinear lookup of the mask grid [X, Y, Z] at world points
    [N, 3] (align corners, border) -> kept where > 0."""
    c = normalize(xyz, aabb)
    vol = grid.permute(2, 1, 0)[None, None]            # [1, 1, Z, Y, X]
    out = F.grid_sample(vol, c.reshape(1, -1, 1, 1, 3), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.reshape(-1) > 0
