"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py):
flatten JAX state into the plain numpy dicts that
joint_tensorf_tpu_torch.convert reads, and compare arrays."""
import numpy as np

from joint_tensorf_tpu_torch.utils.tree import flatten


def _a(x):
    """float32, but bfloat16 (ml_dtypes) stays bfloat16."""
    a = np.asarray(x)
    return a if a.dtype.name == "bfloat16" else a.astype(np.float32)


def as_f32(a):
    """An array of either package (bfloat16 as ml_dtypes or as the port's
    2-byte void) as float32, for comparisons."""
    import ml_dtypes

    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V":
        a = a.view(ml_dtypes.bfloat16)
    return a.astype(np.float32)


def _shading(sh):
    """A JAX shading head's parameter tree (any head's: MLP_Fea's
    ["layers"] list, the "layer1".."layer3" heads, GaRF's, SH's and RGB's
    {}) as numpy, in the same form."""
    if isinstance(sh, dict):
        return {k: _shading(v) for k, v in sh.items()}
    if isinstance(sh, (list, tuple)):
        return [_shading(v) for v in sh]
    return _a(sh)


def flatten_field(st) -> dict:
    """JAX VMState -> the converter's field keys."""
    return {
        "density_planes": [_a(p) for p in st.density_planes],
        "density_lines": [_a(l) for l in st.density_lines],
        "app_planes": [_a(p) for p in st.app_planes],
        "app_lines": [_a(l) for l in st.app_lines],
        "basis": _a(st.basis),
        "shading": _shading(st.shading),
        "aabb": _a(st.aabb),
    }


def flatten_train_state(ts, pose_base=None) -> dict:
    """JAX TrainState -> the converter's full dict."""
    d = flatten_field(ts.params.field)
    d["se3_refine"] = _a(ts.params.se3_refine)
    d["scene_opt"] = {"mu": flatten_field(ts.scene_opt.mu),
                      "nu": flatten_field(ts.scene_opt.nu),
                      "count": int(ts.scene_opt.count)}
    d["pose_opt"] = {"mu": _a(ts.pose_opt.mu), "nu": _a(ts.pose_opt.nu),
                     "count": int(ts.pose_opt.count)}
    d["pose_grad_accum"] = _a(ts.pose_grad_accum)
    if pose_base is not None:
        d["pose_base"] = _a(pose_base)
    return d


def _pose_pair(pair) -> dict:
    """JAX L2G (embedding, warp MLP) pair -> the converter's keys."""
    emb, mlp = pair
    return {"warp_embedding": _a(emb),
            "warp_mlp": [[_a(w), _a(b)] for w, b in mlp]}


def flatten_l2g_state(st) -> dict:
    """JAX L2GState -> the converter's L2G dict."""
    d = flatten_field(st.params.field)
    d.update(_pose_pair((st.params.warp_embedding, st.params.warp_mlp)))
    d["scene_opt"] = {"mu": flatten_field(st.scene_opt.mu),
                      "nu": flatten_field(st.scene_opt.nu),
                      "count": int(st.scene_opt.count)}
    d["pose_opt"] = {"mu": _pose_pair(st.pose_opt.mu),
                     "nu": _pose_pair(st.pose_opt.nu),
                     "count": int(st.pose_opt.count)}
    d["pose_grad_accum"] = _pose_pair(st.pose_grad_accum)
    d["optimised_poses"] = _a(st.optimised_poses)
    d["error_map"] = _a(st.error_map)
    return d


def field_leaves(d: dict) -> dict:
    """A field-shaped dict -> {port parameter name: array}."""
    out = {}
    for g in ("density_planes", "density_lines", "app_planes", "app_lines"):
        for i, a in enumerate(d[g]):
            out[f"{g}.{i}"] = np.asarray(a)
    out["basis"] = np.asarray(d["basis"])
    for k, a in flatten(d["shading"], "shading").items():
        out[k] = np.asarray(a)
    return out


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)
