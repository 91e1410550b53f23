"""The reference's Adam with per-leaf learning rates
(counterpart of joint_tensorf_tpu/train/optim.py).

Not torch.optim.Adam, because of the frozen-leaf rule: a leaf whose
learning rate is 0 keeps its parameter AND its moments, so a non-finite
gradient reaching a frozen leaf cannot poison it for when its rate becomes
nonzero.  Moments and the update are float32; a complex leaf steps its
real part only, as in JAX (_real32).  Parameters and moments are plain
dicts {name: tensor}; updates return new tensors and the caller copies
them into the parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    mu: dict
    nu: dict
    count: int


def adam_init(params: dict) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        count=0)


def _real32(x):
    """float32 of a leaf or gradient; of a complex one its real part, as
    JAX's astype(float32) drops the imaginary part.  So a complex leaf
    (planar_fft's factors) steps its real part only and comes back with
    a zero imaginary part.  torch's .grad of a real loss with respect to
    a complex leaf is the conjugate of JAX's gradient: the real parts
    agree, so taking .real is exact."""
    return x.real if x.is_complex() else x.to(torch.float32)


def adam_update(grads: dict, state: AdamState, params: dict, lrs,
                b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8):
    """One bias-corrected Adam step.  ``lrs``: {name: lr} or one lr.

    Returns (new_params, new_state) as new tensors."""
    count = state.count + 1
    c = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** c)
    mu, nu, new_params = {}, {}, {}
    for k, p in params.items():
        lr = float(np.float32(lrs[k] if isinstance(lrs, dict) else lrs))
        if lr == 0.0:
            mu[k], nu[k], new_params[k] = state.mu[k], state.nu[k], p
            continue
        g = _real32(grads[k])
        mu[k] = b1 * state.mu[k] + (1 - b1) * g
        nu[k] = b2 * state.nu[k] + (1 - b2) * torch.square(g)
        new_params[k] = (_real32(p)
                         - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                         ).to(p.dtype)
    return new_params, AdamState(mu=mu, nu=nu, count=count)


def adam_update_(grads: dict, state: AdamState, params: dict, lrs: dict,
                 b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-8) -> AdamState:
    """adam_update in place on real float32 leaves of one device, each of
    its operations once over every leaf (torch._foreach_*): some 18
    operations a leaf become 14 in all.  The same float32 operations in the
    same order give the same bits as adam_update.  There a tensor over a
    Python scalar is, on a card, a product with the scalar's float32
    reciprocal (PyTorch's kernel computes it so) and elsewhere a division;
    here too.  Leaves whose rate is 0 keep their moments, as there.
    -> the new state, whose moments are ``state``'s, updated."""
    count = state.count + 1
    c = np.float32(count)
    bc1 = np.float32(1.0) - np.float32(b1) ** c
    bc2 = np.float32(1.0) - np.float32(b2) ** c
    keys = [k for k in params if float(np.float32(lrs[k])) != 0.0]
    if keys:
        g = [grads[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        if g[0].device.type == "cuda":
            step = torch._foreach_mul(mu, float(np.float32(1.0) / bc1))
            denom = torch._foreach_mul(nu, float(np.float32(1.0) / bc2))
        else:
            step = torch._foreach_div(mu, float(bc1))
            denom = torch._foreach_div(nu, float(bc2))
        torch._foreach_mul_(step, [float(np.float32(lrs[k])) for k in keys])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_([params[k] for k in keys], step)
    return AdamState(mu=state.mu, nu=state.nu, count=count)


def masked_update(do_step: bool, new_params, new_state, params, state):
    """Step-gated optimizer update (the pose-gradient accumulation
    cadence): the new values when ``do_step``, else the old ones."""
    if do_step:
        return new_params, new_state
    return params, state


def field_lr_tree(field, lr_index: float, lr_basis: float) -> dict:
    """Per-leaf lrs of a VMField: factor grids get lr_index, basis and
    shading lr_basis (the aabb is a buffer and has no entry)."""
    return {name: (lr_index if field.is_factor(name) else lr_basis)
            for name, _ in field.named_parameters()}
