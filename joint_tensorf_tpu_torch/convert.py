"""Train state to and from plain nested dicts of numpy arrays.

The converter never sees a framework type of the other side: a caller
(the parity tests, for JAX state) flattens its state into this dict.

Keys (factor layouts as in the JAX package: planes [H, W, R], lines
[D, R], shading weights [fan_in, fan_out]):

    density_planes, density_lines, app_planes, app_lines   lists of 3 arrays
                   (a CP field's plane lists are empty)
    basis          [sum(app comps), app_dim] (CP: [app comps[0], app_dim])
    shading        the head's tree as the JAX package keeps it, leaves
                   {"w": [fan_in, fan_out], "b": [fan_out]}: {"layers":
                   [...]} (MLP_Fea: 3, MLP_Fea4: 4), {"layer1", "layer2",
                   "layer3"} (the WeakView, WeakView-Density, PE, MLP and
                   Albedo heads), {"fea_gauss", "view_gauss", "layer1",
                   "layer2", "layer3"} (GaRF), {} (SH, RGB)
    aabb           [2, 3]
  optional:
    se3_refine       [V, 6]
    scene_opt        {"mu": F, "nu": F, "count": int}   F: the field keys
                     above except aabb (an "aabb" entry is ignored)
    pose_opt         {"mu": [V, 6], "nu": [V, 6], "count": int}
    pose_grad_accum  [V, 6]
    pose_base        [V, 3, 4]

L2G-BAT's state (l2g_state_from_numpy / l2g_to_numpy) holds the field
keys and scene_opt as above, and instead of the pose table:

    warp_embedding   [V, E]
    warp_mlp         [[W [fan_in, fan_out], b [fan_out]], ...]
    pose_opt         {"mu": P, "nu": P, "count": int}   P: {"warp_embedding",
                     "warp_mlp"} shaped as above
    pose_grad_accum  P
    optimised_poses  [V, 3, 4]
    error_map        [V, ems * ems]

The trainers without phases (BARF / MLP-NeRF, the planar images) keep a
flat {name: tensor} parameter dict and its AdamState; simple_to_numpy /
simple_state_from_numpy carry them as

    params     the JAX params as a nested dict: BARF's {"mlp": M,
               "se3_refine": [V, 6], "mlp_fine": M (with fine sampling)},
               M = {"feat": [{"w", "b"}, ...], "rgb": [...]}; the planar
               {"image": I, "warp": [B, dof]}, I = {"rank1", "rank2"}
               (SVD: float32; FFT: complex64) or the MLP's [{"w", "b"}, ...]
    opt_state  {"mu": like params, "nu": like params, "count": int}
               (moments float32, also for complex leaves)

Under the comp layout (parallel/) the dicts stay the unsharded ones: the
*_from_numpy functions take the rank's mesh as ``comp`` and keep its block
of every factor's components (their Adam moments too); to_numpy and
l2g_to_numpy gather the blocks of every comp rank (a collective: every
rank of the comp group calls them together).

Arrays are float32, but for bfloat16 factors (tpu.factor_dtype), which
stay bfloat16 both ways.  numpy has no bfloat16: the JAX package's arrays
are ml_dtypes.bfloat16, which np.savez writes and np.load reads back as
2-byte void ('|V2'); either is taken bit for bit, and to_numpy gives '|V2'.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import vm as vm_lib
from .parallel import sharding
from .train import l2g as l2g_lib
from .train.optim import AdamState
from .train.step import TrainState, init_train_state
from .utils import tree as tree_lib

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


def _block(a, group: str, i: int, comp):
    """This rank's component block of factor ``group[i]`` (the whole
    array without ``comp``)."""
    if comp is None:
        return a
    a = np.asarray(a)
    return a[..., vm_lib.factor_block(comp, group, i, a.shape[-1])]


def field_from_numpy(d: dict, cfg: vm_lib.VMConfig, device=None,
                     comp=None) -> vm_lib.VMField:
    shading = vm_lib.make_shading(cfg, device)
    leaves = {k: _t(a, device)
              for k, a in tree_lib.flatten(d["shading"]).items()}
    want = dict(shading.named_parameters())
    for k, p in want.items():
        if k not in leaves or leaves[k].shape != p.shape:
            raise ValueError(
                f"shading.{k}: {tuple(leaves[k].shape) if k in leaves else 'missing'}"
                f", the config's {cfg.shading_mode} wants {tuple(p.shape)}")
    if set(leaves) != set(want):
        raise ValueError(f"shading leaves {sorted(set(leaves) - set(want))} "
                         f"are not {cfg.shading_mode}'s")
    shading.load_state_dict(leaves)
    return vm_lib.VMField(
        *[[_t(_block(a, g, i, comp), device) for i, a in enumerate(d[g])]
          for g in _GROUPS],
        basis=_t(d["basis"], device), shading=shading,
        aabb=_t(d["aabb"], device), comp=comp)


def _moments_from_numpy(tree: dict, field: vm_lib.VMField, device) -> dict:
    """Field-shaped moment dict -> {parameter name: tensor}."""
    out = {}
    for name, _ in field.named_parameters():
        head, *rest = name.split(".")
        if head in _GROUPS:
            i = int(rest[0])
            out[name] = _t(_block(tree[head][i], head, i, field.comp), device)
        elif head == "basis":
            out[name] = _t(tree["basis"], device)
        else:                                   # shading.<JAX path>
            out[name] = _t(tree_lib.flatten(tree["shading"])[".".join(rest)],
                           device)
    return out


def _scene_opt_from_numpy(so: dict, field, device) -> AdamState:
    return AdamState(mu=_moments_from_numpy(so["mu"], field, device),
                     nu=_moments_from_numpy(so["nu"], field, device),
                     count=int(so["count"]))


def train_state_from_numpy(d: dict, cfg: vm_lib.VMConfig, device=None,
                           comp=None):
    """-> (TrainState, pose_base tensor or None); ``comp``: the rank's
    mesh under the comp layout (its component blocks kept)."""
    field = field_from_numpy(d, cfg, device, comp)
    se3 = np.asarray(d.get("se3_refine", np.zeros((1, 6))), np.float32)
    state = init_train_state(field, se3.shape[0])
    with torch.no_grad():
        state.se3_refine.copy_(_t(se3, device))
    if "scene_opt" in d:
        state.scene_opt = _scene_opt_from_numpy(d["scene_opt"], field, device)
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
    """``t`` as a numpy array of its own memory: a CPU tensor is copied,
    so the array outlives in-place changes to the tensor (a queued
    checkpoint write reads it after the next optimiser step)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _field_tree(named: dict) -> dict:
    """{parameter name: tensor} -> the field-shaped dict of numpy arrays."""
    tree = {g: [] for g in _GROUPS}
    shading = {}
    for name, t in named.items():
        head, *rest = name.split(".")
        if head in _GROUPS:
            tree[head].append(_np(t))
        elif head == "basis":
            tree["basis"] = _np(t)
        else:
            shading[".".join(rest)] = _np(t)
    tree["shading"] = tree_lib.unflatten(shading) or {}
    return tree


def gathered(field, named: dict) -> dict:
    """{parameter name: tensor} with every factor's components gathered
    under ``field.comp``."""
    if field.comp is None:
        return named
    return {k: sharding.gather_comp(field.comp, t) if field.is_factor(k)
            else t for k, t in named.items()}


def _field_numpy(state) -> dict:
    """The field keys, aabb and scene_opt of a TrainState or L2GState (the
    components gathered under the comp layout)."""
    f = state.field
    d = _field_tree(gathered(f, dict(f.named_parameters())))
    d["aabb"] = _np(f.aabb)
    d["scene_opt"] = {"mu": _field_tree(gathered(f, state.scene_opt.mu)),
                      "nu": _field_tree(gathered(f, state.scene_opt.nu)),
                      "count": state.scene_opt.count}
    return d


def to_numpy(state: TrainState, pose_base=None) -> dict:
    """The inverse of train_state_from_numpy, for comparisons."""
    d = _field_numpy(state)
    d["se3_refine"] = _np(state.se3_refine)
    d["pose_opt"] = {"mu": _np(state.pose_opt.mu["se3_refine"]),
                     "nu": _np(state.pose_opt.nu["se3_refine"]),
                     "count": state.pose_opt.count}
    d["pose_grad_accum"] = _np(state.pose_grad_accum)
    if pose_base is not None:
        d["pose_base"] = _np(pose_base)
    return d


# ------------------------------------------------------------------ L2G-BAT
def _pose_tree(flat: dict) -> dict:
    """{pose parameter name: tensor} (l2g.pose_params' keys) -> P."""
    n = len([k for k in flat if k.startswith("warp_mlp.w.")])
    return {"warp_embedding": _np(flat["warp_embedding"]),
            "warp_mlp": [[_np(flat[f"warp_mlp.w.{i}"]),
                          _np(flat[f"warp_mlp.b.{i}"])] for i in range(n)]}


def _pose_flat(tree: dict, device) -> dict:
    """The inverse of _pose_tree."""
    out = {"warp_embedding": _t(tree["warp_embedding"], device)}
    for i, (w, b) in enumerate(tree["warp_mlp"]):
        out[f"warp_mlp.w.{i}"] = _t(w, device)
        out[f"warp_mlp.b.{i}"] = _t(b, device)
    return out


def l2g_state_from_numpy(d: dict, cfg: vm_lib.VMConfig,
                         l2g_cfg: "l2g_lib.L2GConfig", device=None,
                         comp=None):
    """-> L2GState (``comp`` as train_state_from_numpy's)."""
    field = field_from_numpy(d, cfg, device, comp)
    state = l2g_lib.init_l2g_state(
        field, l2g_cfg, int(np.shape(d["warp_embedding"])[0]),
        _t(d["optimised_poses"], device), device=device)
    with torch.no_grad():
        for k, v in _pose_flat({"warp_embedding": d["warp_embedding"],
                                "warp_mlp": d["warp_mlp"]}, device).items():
            l2g_lib.pose_params(state)[k].copy_(v)
    state.error_map = _t(d["error_map"], device)
    if "scene_opt" in d:
        state.scene_opt = _scene_opt_from_numpy(d["scene_opt"], field, device)
    if "pose_opt" in d:
        po = d["pose_opt"]
        state.pose_opt = AdamState(mu=_pose_flat(po["mu"], device),
                                   nu=_pose_flat(po["nu"], device),
                                   count=int(po["count"]))
    if "pose_grad_accum" in d:
        state.pose_grad_accum = _pose_flat(d["pose_grad_accum"], device)
    return state


def l2g_to_numpy(state) -> dict:
    """The inverse of l2g_state_from_numpy, for comparisons and
    checkpoints."""
    d = _field_numpy(state)
    d.update(_pose_tree(l2g_lib.pose_params(state)))
    d["pose_opt"] = {"mu": _pose_tree(state.pose_opt.mu),
                     "nu": _pose_tree(state.pose_opt.nu),
                     "count": state.pose_opt.count}
    d["pose_grad_accum"] = _pose_tree(state.pose_grad_accum)
    d["optimised_poses"] = _np(state.optimised_poses)
    d["error_map"] = _np(state.error_map)
    return d


# ------------------------------------------------- BARF / planar (no phases)
def _leaf(a, device) -> torch.Tensor:
    """A numpy leaf of a simple state: complex stays complex64, the rest
    becomes float32."""
    a = np.asarray(a)
    dtype = np.complex64 if np.iscomplexobj(a) else np.float32
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def simple_to_numpy(params: dict, opt_state: AdamState) -> dict:
    """A flat parameter dict and its AdamState -> {"params",
    "opt_state"} of nested numpy arrays (see the module docstring)."""
    def nested(flat):
        return tree_lib.unflatten({k: _np(v) for k, v in flat.items()})
    return {"params": nested(params),
            "opt_state": {"mu": nested(opt_state.mu),
                          "nu": nested(opt_state.nu),
                          "count": int(opt_state.count)}}


def simple_state_from_numpy(d: dict, device=None):
    """The inverse of simple_to_numpy -> (flat params, each requiring a
    gradient; AdamState)."""
    params = {k: _leaf(v, device).requires_grad_(True)
              for k, v in tree_lib.flatten(d["params"]).items()}
    so = d["opt_state"]
    state = AdamState(
        mu={k: _leaf(v, device) for k, v in tree_lib.flatten(so["mu"]).items()},
        nu={k: _leaf(v, device) for k, v in tree_lib.flatten(so["nu"]).items()},
        count=int(so["count"]))
    return params, state
