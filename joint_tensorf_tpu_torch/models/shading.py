"""Shading heads: appearance features (+ view directions, + sample points)
-> RGB (counterpart of joint_tensorf_tpu/models/shading.py:77-329, the
reference's renderModule zoo).

Every head is called as JAX calls its apply:

    head(pts [N, 3], viewdirs [N, 3], features [N, app_dim],
         view_pe_progress, fea_pe_progress) -> rgb [N, 3]

and MLP_Fea_WeakView_Density (``predicts_density``) returns (rgb, the
density feature [N]).  Only MLP_PE reads ``pts``; MLP_PE, MLP and
MLP_Albedo encode without the progress mask (progress 1), as JAX's do.

Heads by the configs' names: MLP_Fea and MLP_Fea4 (3 or 4 layers),
MLP_Fea_WeakView and MLP_Fea_WeakView_Density, MLP_PE, MLP, MLP_Albedo,
GaRF (Gaussian activations), SH (degree-2 spherical harmonics over the
features as coefficients) and RGB (the features are the colour).

Weights are stored [fan_in, fan_out], the reference's layout
(joint_tensorf_tpu/models/shading.py:54), the transpose of nn.Linear's.
The parameters are named as the JAX package's head tree nests them, so a
parameter's name below ``shading.`` is its dotted JAX path
(utils/tree.py): ``layers.{i}.w`` (MLP_Fea, MLP_Fea4), ``layer{1,2,3}.b``
(the WeakView, PE, MLP and Albedo heads), ``fea_gauss.w`` /
``view_gauss.w`` / ``layer{1,2,3}.w`` (GaRF); SH and RGB hold none.
Initial values are drawn from a torch.Generator with nn.Linear's default
bounds, U(+-1/sqrt(fan_in)), the last bias zero where the reference's is
(GaRF's weights U(+-0.1)); parity tests copy JAX's values instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.sh import eval_sh_bases


def positional_encoding(positions, freqs: int, progress=1.0):
    """Frequency encoding with linear coarse-to-fine annealing:
    mask_l = clip(progress*F - l, 0, 1); output [..., D*2F] =
    concat(sin, cos) over (D, F)."""
    levels = torch.arange(freqs, dtype=positions.dtype,
                          device=positions.device)
    freq_bands = 2.0**levels
    mask = torch.clamp(progress * freqs - levels, 0.0, 1.0)
    pts = positions[..., None] * freq_bands          # [..., D, F]
    enc = torch.cat([torch.sin(pts) * mask, torch.cos(pts) * mask], dim=-1)
    return enc.reshape(positions.shape[:-1]
                       + (freqs * 2 * positions.shape[-1],))


class Linear(nn.Module):
    """x @ w + b with w [fan_in, fan_out], drawn w then b: U(+-bound) for
    the weight (bound 1/sqrt(fan_in) unless given) and U(+-1/sqrt(fan_in))
    for the bias, or a zero bias."""

    def __init__(self, fan_in: int, fan_out: int, generator, device,
                 zero_bias: bool = False, w_bound: float | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)

        def uniform(shape, b):
            return (torch.rand(shape, generator=generator, device=device)
                    * 2 - 1) * b

        self.w = nn.Parameter(uniform((fan_in, fan_out),
                                      bound if w_bound is None else w_bound))
        self.b = nn.Parameter(torch.zeros(fan_out, device=device)
                              if zero_bias else uniform((fan_out,), bound))

    def forward(self, x):
        return x @ self.w + self.b


class Head(nn.Module):
    """A shading head; ``predicts_density``: it returns (rgb, sigma_fea)."""
    predicts_density = False


class MLPFea(Head):
    """MLPRender_Fea (n_layers 3) and MLPRender_Fea4 (4):
    [features, viewdirs, PE(features), PE(viewdirs)] -> (Linear/ReLU) x
    (n - 1) -> Linear -> sigmoid."""

    def __init__(self, app_dim: int, view_pe: int = 6, fea_pe: int = 6,
                 hidden: int = 128, device=None,
                 generator: torch.Generator | None = None,
                 n_layers: int = 3):
        super().__init__()
        self.view_pe, self.fea_pe = view_pe, fea_pe
        in_dim = 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
        dims = [in_dim] + [hidden] * (n_layers - 1) + [3]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], generator, device,
                   zero_bias=i == n_layers - 1) for i in range(n_layers))

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = [features, viewdirs]
        if self.fea_pe > 0:
            indata.append(positional_encoding(features, self.fea_pe,
                                              fea_pe_progress))
        if self.view_pe > 0:
            indata.append(positional_encoding(viewdirs, self.view_pe,
                                              view_pe_progress))
        x = torch.cat(indata, dim=-1)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return torch.sigmoid(x)


class MLPFeaWeakView(Head):
    """MLPRender_Fea_WeakView: the view directions' encoding joins only at
    the last layer: [features, PE(features)] -> Linear/ReLU -> Linear/ReLU
    -> [PE(viewdirs), x] -> Linear -> sigmoid.  With ``predict_density``
    (MLP_Fea_WeakView_Density) layer 2 is hidden + 1 wide and its last
    channel, before the ReLU, is the density feature."""

    def __init__(self, app_dim: int, view_pe: int = 6, fea_pe: int = 6,
                 hidden: int = 128, device=None,
                 generator: torch.Generator | None = None,
                 predict_density: bool = False):
        super().__init__()
        self.view_pe, self.fea_pe = view_pe, fea_pe
        self.predicts_density = predict_density
        in_dim = (2 * fea_pe + 1) * app_dim
        self.layer1 = Linear(in_dim, hidden, generator, device)
        self.layer2 = Linear(hidden, hidden + int(predict_density),
                             generator, device)
        self.layer3 = Linear(hidden + 2 * view_pe * 3, 3, generator, device,
                             zero_bias=True)

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = [features]
        if self.fea_pe > 0:
            indata.append(positional_encoding(features, self.fea_pe,
                                              fea_pe_progress))
        x = torch.relu(self.layer1(torch.cat(indata, dim=-1)))
        x = self.layer2(x)
        if self.predicts_density:
            sigma_fea, x = x[..., -1], x[..., :-1]
        x = torch.relu(x)
        middata = []
        if self.view_pe > 0:
            middata.append(positional_encoding(viewdirs, self.view_pe,
                                               view_pe_progress))
        middata.append(x)
        rgb = torch.sigmoid(self.layer3(torch.cat(middata, dim=-1)))
        return (rgb, sigma_fea) if self.predicts_density else rgb


class _ThreeLayer(Head):
    """Linear/ReLU -> Linear/ReLU -> Linear -> sigmoid over the encoded
    input (the PE, MLP and Albedo heads)."""

    def _layers(self, in_dim, hidden, generator, device):
        self.layer1 = Linear(in_dim, hidden, generator, device)
        self.layer2 = Linear(hidden, hidden, generator, device)
        self.layer3 = Linear(hidden, 3, generator, device, zero_bias=True)

    def _mlp(self, indata):
        x = torch.relu(self.layer1(torch.cat(indata, dim=-1)))
        x = torch.relu(self.layer2(x))
        return torch.sigmoid(self.layer3(x))


class MLPPE(_ThreeLayer):
    """MLPRender_PE: [features, viewdirs, pts, PE(pts), PE(viewdirs)]."""

    def __init__(self, app_dim: int, view_pe: int = 6, pos_pe: int = 6,
                 hidden: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.view_pe, self.pos_pe = view_pe, pos_pe
        self._layers((3 + 2 * view_pe * 3) + (3 + 2 * pos_pe * 3) + app_dim,
                     hidden, generator, device)

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = [features, viewdirs, pts]
        if self.pos_pe > 0:
            indata.append(positional_encoding(pts, self.pos_pe))
        if self.view_pe > 0:
            indata.append(positional_encoding(viewdirs, self.view_pe))
        return self._mlp(indata)


class MLP(_ThreeLayer):
    """MLPRender: [features, viewdirs, PE(viewdirs)]."""

    def __init__(self, app_dim: int, view_pe: int = 6, hidden: int = 128,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.view_pe = view_pe
        self._layers((3 + 2 * view_pe * 3) + app_dim, hidden, generator,
                     device)

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = [features, viewdirs]
        if self.view_pe > 0:
            indata.append(positional_encoding(viewdirs, self.view_pe))
        return self._mlp(indata)


class MLPAlbedo(_ThreeLayer):
    """MLP_Albedo: [features, PE(features)], no view dependence."""

    def __init__(self, app_dim: int, fea_pe: int = 6, hidden: int = 128,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.fea_pe = fea_pe
        self._layers(2 * fea_pe * app_dim + app_dim, hidden, generator,
                     device)

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = [features]
        if self.fea_pe > 0:
            indata.append(positional_encoding(features, self.fea_pe))
        return self._mlp(indata)


class GaRF(Head):
    """GaRF_Render: Gaussian activations exp(-x^2 / 2 sigma^2), the input
    projections' mean-centred; [view, gauss(layer1(features))] ->
    layer2 -> layer3 -> sigmoid."""

    def __init__(self, app_dim: int, hidden: int = 128, device=None,
                 generator: torch.Generator | None = None,
                 sigma: float = 0.1, init_range: float = 0.1):
        super().__init__()
        self.sigma = sigma

        def lin(fan_in, fan_out):
            return Linear(fan_in, fan_out, generator, device,
                          w_bound=init_range)

        self.fea_gauss = lin(app_dim, hidden)
        self.view_gauss = lin(3, hidden)
        self.layer1 = lin(hidden, hidden)
        self.layer2 = lin(2 * hidden, hidden)
        self.layer3 = lin(hidden, 3)

    def _gauss(self, x):
        return torch.exp(-0.5 * x**2 / self.sigma**2)

    def _gauss_centered(self, x):
        return self._gauss(x - x.mean(dim=-1, keepdim=True))

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = self._gauss_centered(self.fea_gauss(features))
        view = self._gauss_centered(self.view_gauss(viewdirs))
        x = self._gauss(self.layer1(indata))
        x = self._gauss(self.layer2(torch.cat([view, x], dim=-1)))
        return torch.sigmoid(self.layer3(x))


class SH(Head):
    """SHRender: the features are degree-2 SH coefficients, 9 per colour
    channel: relu(sum_b bases_b * coeffs_{c, b} + 0.5)."""

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        sh_mult = eval_sh_bases(2, viewdirs)[:, None]         # [N, 1, 9]
        rgb_sh = features.reshape(-1, 3, sh_mult.shape[-1])
        return torch.relu(torch.sum(sh_mult * rgb_sh, dim=-1) + 0.5)


class RGB(Head):
    """RGBRender: the features are the colour (app_dim 3)."""

    def forward(self, pts, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        return features


def make_head(name: str, app_dim: int, view_pe: int, pos_pe: int,
              fea_pe: int, hidden: int, device=None,
              generator: torch.Generator | None = None) -> Head:
    """The head of a shadingMode name (the JAX package's
    make_shading_head), drawn from ``generator``."""
    kw = dict(device=device, generator=generator)
    if name in ("MLP_Fea", "MLP_Fea4"):
        return MLPFea(app_dim, view_pe, fea_pe, hidden,
                      n_layers=4 if name == "MLP_Fea4" else 3, **kw)
    if name in ("MLP_Fea_WeakView", "MLP_Fea_WeakView_Density"):
        return MLPFeaWeakView(app_dim, view_pe, fea_pe, hidden,
                              predict_density=name.endswith("_Density"),
                              **kw)
    if name == "MLP_PE":
        return MLPPE(app_dim, view_pe, pos_pe, hidden, **kw)
    if name == "MLP":
        return MLP(app_dim, view_pe, hidden, **kw)
    if name == "MLP_Albedo":
        return MLPAlbedo(app_dim, fea_pe, hidden, **kw)
    if name == "GaRF":
        return GaRF(app_dim, hidden, **kw)
    if name == "SH":
        return SH()
    if name == "RGB":
        if app_dim != 3:
            raise ValueError(f"the RGB head needs app_dim 3, got {app_dim}")
        return RGB()
    raise ValueError(f"Unrecognized shading head {name!r}")


HEAD_NAMES = ("MLP_Fea", "MLP_Fea4", "MLP_Fea_WeakView",
              "MLP_Fea_WeakView_Density", "MLP_PE", "MLP", "MLP_Albedo",
              "GaRF", "SH", "RGB")
