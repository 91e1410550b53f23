"""Shading heads: appearance features (+ viewdirs) -> RGB
(counterpart of joint_tensorf_tpu/models/shading.py: MLP_Fea, the Blender
configs' head, and MLP_Fea_WeakView, the LLFF configs').

Weights are stored [fan_in, fan_out], the reference's layout
(joint_tensorf_tpu/models/shading.py:54), the transpose of nn.Linear's, so
state converts without transposes and the parity tests compare like with
like.  Both heads hold three layers as ``w.i`` / ``b.i``; the JAX package
keeps MLP_Fea's as ``['layers'][i]`` and MLP_Fea_WeakView's as
``['layer{i+1}']`` (convert.py maps the two).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn


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


def _init_layers(module, dims, generator, device):
    """Three [fan_in, fan_out] layers with torch.nn.Linear's default init,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the last bias starts at zero, like
    the reference's."""
    module.w = nn.ParameterList()
    module.b = nn.ParameterList()
    for i in range(3):
        bound = 1.0 / math.sqrt(dims[i][0])
        w = (torch.rand(dims[i], generator=generator, device=device)
             * 2 - 1) * bound
        b = (torch.zeros(dims[i][1], device=device) if i == 2
             else (torch.rand(dims[i][1], generator=generator,
                              device=device) * 2 - 1) * bound)
        module.w.append(nn.Parameter(w))
        module.b.append(nn.Parameter(b))


class MLPFea(nn.Module):
    """MLPRender_Fea: [features, viewdirs, PE(features), PE(viewdirs)] ->
    Linear/ReLU -> Linear/ReLU -> Linear -> sigmoid."""

    def __init__(self, app_dim: int, view_pe: int = 6, fea_pe: int = 6,
                 hidden: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.view_pe = view_pe
        self.fea_pe = fea_pe
        in_dim = 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
        _init_layers(self, [(in_dim, hidden), (hidden, hidden), (hidden, 3)],
                     generator, device)

    def forward(self, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = [features, viewdirs]
        if self.fea_pe > 0:
            indata.append(positional_encoding(features, self.fea_pe,
                                              fea_pe_progress))
        if self.view_pe > 0:
            indata.append(positional_encoding(viewdirs, self.view_pe,
                                              view_pe_progress))
        x = torch.cat(indata, dim=-1)
        n = len(self.w)
        for i in range(n):
            x = x @ self.w[i] + self.b[i]
            if i + 1 < n:
                x = torch.relu(x)
        return torch.sigmoid(x)


class MLPFeaWeakView(nn.Module):
    """MLPRender_Fea_WeakView: the view directions' encoding joins only at
    the last layer: [features, PE(features)] -> Linear/ReLU -> Linear/ReLU
    -> [PE(viewdirs), x] -> Linear -> sigmoid (the JAX package's
    make_mlp_fea_weakview without predict_density)."""

    def __init__(self, app_dim: int, view_pe: int = 6, fea_pe: int = 6,
                 hidden: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.view_pe = view_pe
        self.fea_pe = fea_pe
        in_dim = (2 * fea_pe + 1) * app_dim
        _init_layers(self, [(in_dim, hidden), (hidden, hidden),
                            (hidden + 2 * view_pe * 3, 3)], generator, device)

    def forward(self, viewdirs, features, view_pe_progress=1.0,
                fea_pe_progress=1.0):
        indata = [features]
        if self.fea_pe > 0:
            indata.append(positional_encoding(features, self.fea_pe,
                                              fea_pe_progress))
        x = torch.relu(torch.cat(indata, dim=-1) @ self.w[0] + self.b[0])
        x = torch.relu(x @ self.w[1] + self.b[1])
        middata = []
        if self.view_pe > 0:
            middata.append(positional_encoding(viewdirs, self.view_pe,
                                               view_pe_progress))
        middata.append(x)
        return torch.sigmoid(torch.cat(middata, dim=-1) @ self.w[2]
                             + self.b[2])


SHADING_HEADS = {"MLP_Fea": MLPFea, "MLP_Fea_WeakView": MLPFeaWeakView}
