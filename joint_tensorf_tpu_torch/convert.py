"""Train state to and from plain nested dicts of numpy arrays.

The converter never sees a framework type of the other side: a caller
(the parity tests, for JAX state) flattens its state into this dict.

Keys (factor layouts as in the JAX package: planes [H, W, R], lines
[D, R], shading weights [fan_in, fan_out]):

    density_planes, density_lines, app_planes, app_lines   lists of 3 arrays
    basis                                                  [sum(app comps), app_dim]
    shading        {"layers": [{"w": [fan_in, fan_out], "b": [fan_out]}, ...]}
    aabb           [2, 3]
  optional:
    se3_refine       [V, 6]
    scene_opt        {"mu": F, "nu": F, "count": int}   F: the field keys
                     above except aabb (an "aabb" entry is ignored)
    pose_opt         {"mu": [V, 6], "nu": [V, 6], "count": int}
    pose_grad_accum  [V, 6]
    pose_base        [V, 3, 4]

Arrays are float32, but for bfloat16 factors (tpu.factor_dtype), which
stay bfloat16 both ways.  numpy has no bfloat16: the JAX package's arrays
are ml_dtypes.bfloat16, which np.savez writes and np.load reads back as
2-byte void ('|V2'); either is taken bit for bit, and to_numpy gives '|V2'.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .models import vm as vm_lib
from .models.shading import MLPFea
from .train.optim import AdamState
from .train.step import TrainState, init_train_state

_GROUPS = ("density_planes", "density_lines", "app_planes", "app_lines")


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                      or a.dtype.name == "bfloat16")


def _t(x, device):
    a = np.asarray(x)
    if _is_bf16(a):
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def field_from_numpy(d: dict, cfg: vm_lib.VMConfig, device=None) -> vm_lib.VMField:
    shading = MLPFea(cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.hidden,
                     device=device)
    for i, layer in enumerate(d["shading"]["layers"]):
        for key, plist in (("w", shading.w), ("b", shading.b)):
            t = _t(layer[key], device)
            if t.shape != plist[i].shape:
                raise ValueError(f"shading.layers[{i}].{key}: shape "
                                 f"{tuple(t.shape)}, the config wants "
                                 f"{tuple(plist[i].shape)}")
            plist[i] = nn.Parameter(t)
    return vm_lib.VMField(
        *[[_t(a, device) for a in d[g]] for g in _GROUPS],
        basis=_t(d["basis"], device), shading=shading,
        aabb=_t(d["aabb"], device))


def _moments_from_numpy(tree: dict, field: vm_lib.VMField, device) -> dict:
    """Field-shaped moment dict -> {parameter name: tensor}."""
    out = {}
    for name, _ in field.named_parameters():
        head, *rest = name.split(".")
        if head in _GROUPS:
            out[name] = _t(tree[head][int(rest[0])], device)
        elif head == "basis":
            out[name] = _t(tree["basis"], device)
        else:                                   # shading.{w,b}.i
            out[name] = _t(tree["shading"]["layers"][int(rest[1])][rest[0]],
                           device)
    return out


def train_state_from_numpy(d: dict, cfg: vm_lib.VMConfig, device=None):
    """-> (TrainState, pose_base tensor or None)."""
    field = field_from_numpy(d, cfg, device)
    se3 = np.asarray(d.get("se3_refine", np.zeros((1, 6))), np.float32)
    state = init_train_state(field, se3.shape[0])
    with torch.no_grad():
        state.se3_refine.copy_(_t(se3, device))
    if "scene_opt" in d:
        so = d["scene_opt"]
        state.scene_opt = AdamState(
            mu=_moments_from_numpy(so["mu"], field, device),
            nu=_moments_from_numpy(so["nu"], field, device),
            count=int(so["count"]))
    if "pose_opt" in d:
        po = d["pose_opt"]
        state.pose_opt = AdamState(
            mu={"se3_refine": _t(po["mu"], device)},
            nu={"se3_refine": _t(po["nu"], device)},
            count=int(po["count"]))
    if "pose_grad_accum" in d:
        state.pose_grad_accum = _t(d["pose_grad_accum"], device)
    pose_base = (_t(d["pose_base"], device) if "pose_base" in d else None)
    return state, pose_base


def _np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _field_tree(named: dict) -> dict:
    """{parameter name: tensor} -> the field-shaped dict of numpy arrays."""
    tree = {g: [] for g in _GROUPS}
    layers: dict[int, dict] = {}
    for name, t in named.items():
        head, *rest = name.split(".")
        if head in _GROUPS:
            tree[head].append(_np(t))
        elif head == "basis":
            tree["basis"] = _np(t)
        else:
            layers.setdefault(int(rest[1]), {})[rest[0]] = _np(t)
    tree["shading"] = {"layers": [layers[i] for i in sorted(layers)]}
    return tree


def to_numpy(state: TrainState, pose_base=None) -> dict:
    """The inverse of train_state_from_numpy, for comparisons."""
    d = _field_tree(dict(state.field.named_parameters()))
    d["aabb"] = _np(state.field.aabb)
    d["se3_refine"] = _np(state.se3_refine)
    d["scene_opt"] = {"mu": _field_tree(state.scene_opt.mu),
                      "nu": _field_tree(state.scene_opt.nu),
                      "count": state.scene_opt.count}
    d["pose_opt"] = {"mu": _np(state.pose_opt.mu["se3_refine"]),
                     "nu": _np(state.pose_opt.nu["se3_refine"]),
                     "count": state.pose_opt.count}
    d["pose_grad_accum"] = _np(state.pose_grad_accum)
    if pose_base is not None:
        d["pose_base"] = _np(pose_base)
    return d
