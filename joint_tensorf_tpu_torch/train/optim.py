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


def adam_scales(count: int, b1: float, b2: float, device) -> tuple:
    """Adam's bias corrections at step ``count`` as adam_update_ applies
    them on ``device``: their float32 reciprocals on a card, which
    multiply there, the corrections themselves elsewhere, which divide
    (as adam_update's division by a host scalar computes on each)."""
    c = np.float32(count)
    bc1 = np.float32(1.0) - np.float32(b1) ** c
    bc2 = np.float32(1.0) - np.float32(b2) ** c
    if torch.device(device).type == "cuda":
        return float(np.float32(1.0) / bc1), float(np.float32(1.0) / bc2)
    return float(bc1), float(bc2)


def frozen(lr) -> bool:
    """A host rate that float32 rounds to 0: its leaf keeps its parameter
    and moments (adam_update's frozen-leaf rule).  A tensor rate is never
    frozen: its caller leaves a frozen leaf out beforehand."""
    return not isinstance(lr, torch.Tensor) and float(np.float32(lr)) == 0.0


def _step_sizes(mu, nu, lrs, scales, eps):
    """Each leaf's Adam step lr * (mu / bc1) / (sqrt(nu / bc2) + eps) from
    its updated moments, as new tensors, in adam_update's operations and
    order; ``scales`` as adam_scales gives them, host floats or 0-d
    tensors, and ``lrs`` a list of host floats or one of 0-d tensors."""
    if mu[0].device.type == "cuda":
        step = torch._foreach_mul(mu, scales[0])
        denom = torch._foreach_mul(nu, scales[1])
    else:
        step = torch._foreach_div(mu, scales[0])
        denom = torch._foreach_div(nu, scales[1])
    torch._foreach_mul_(step, lrs)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(step, denom)
    return step


def adam_update_(grads: dict, state: AdamState, params: dict, lrs: dict,
                 b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                 scales=None) -> AdamState:
    """adam_update in place on real float32 leaves of one device, each of
    its operations once over every leaf (torch._foreach_*): some 18
    operations a leaf become 14 in all.  The same float32 operations in the
    same order give the same bits as adam_update.  There a tensor over a
    Python scalar is, on a card, a product with the scalar's float32
    reciprocal (PyTorch's kernel computes it so) and elsewhere a division;
    here too (adam_scales).  Leaves whose rate is 0 keep their moments, as
    there.  A rate may be a 0-d float32 tensor on the leaves' device and
    ``scales`` adam_scales' pair as two such tensors (a step captured in a
    CUDA graph reads them there; a float32 product with a 0-d tensor gives
    the bits of one with the host float it holds): then every leaf with a
    tensor rate steps, and ``scales`` stand for step state.count + 1.
    -> the new state, whose moments are ``state``'s, updated."""
    count = state.count + 1
    keys = [k for k in params if not frozen(lrs[k])]
    if keys:
        g = [grads[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        if scales is None:
            scales = adam_scales(count, b1, b2, g[0].device)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        rates = [lrs[k] if isinstance(lrs[k], torch.Tensor)
                 else float(np.float32(lrs[k])) for k in keys]
        torch._foreach_sub_([params[k] for k in keys],
                            _step_sizes(mu, nu, rates, scales, eps))
    return AdamState(mu=state.mu, nu=state.nu, count=count)


def masked_adam_update_(grads: dict, state: AdamState, params: dict, lr,
                        do_step, scales, b1: float = 0.9, b2: float = 0.99,
                        eps: float = 1e-8):
    """adam_update and then masked_update(do_step, ...) in place: each
    leaf's moments and parameter take adam_update's new values where
    ``do_step`` is set and keep their bits where not.  ``do_step``: a host
    bool (adam_update_ runs or nothing does) or, where the cadence is a
    device value (the pose update of a step captured in a CUDA graph), a
    0-d bool tensor (torch.where selects).  ``lr``: one rate for every
    leaf, a 0-d tensor or a nonzero host float (a frozen leaf is the
    caller's to leave out); ``scales``: adam_scales' pair for step
    state.count + 1.  The count is the caller's too: it advances with
    do_step, which the caller knows on the host."""
    if not isinstance(do_step, torch.Tensor):
        if do_step:
            adam_update_(grads, state, params, {k: lr for k in params},
                         b1, b2, eps, scales)
        return
    keys = list(params)
    g = [grads[k] for k in keys]
    mu_old = [state.mu[k] for k in keys]
    nu_old = [state.nu[k] for k in keys]
    mu = torch._foreach_mul(mu_old, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    nu = torch._foreach_mul(nu_old, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - b2))
    step = _step_sizes(mu, nu, [lr] * len(keys), scales, eps)
    for k, m, v, s in zip(keys, mu, nu, step):
        p = params[k]
        p.copy_(torch.where(do_step, p - s, p))
        state.mu[k].copy_(torch.where(do_step, m, state.mu[k]))
        state.nu[k].copy_(torch.where(do_step, v, state.nu[k]))


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
