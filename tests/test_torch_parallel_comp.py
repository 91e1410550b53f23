"""PyTorch port vs JAX: the comp layout of parallel/ (the factor components
split over ranks, ``tpu.mesh_shape`` [R, C] over ``mesh_axes`` [rays,
comp]), the counterpart of tests/test_sharding.py's comp-sharded tests,
on gloo ranks on the CPU started by parallel.launch.spawn: one spawn of 2
ranks ([1, 2]), one of 4 ([2, 2]), and one step of 4 ranks under the
other axis order ([comp, rays]).  The children import only the port.

The component counts divide by 2 (4 a plane for density and
appearance).  The sharded runs are held against JAX's UNSHARDED step and
trainer at tests/test_torch_parallel.py's tolerances (loss at rtol 1e-4,
gradients at 1e-4 of each leaf's largest entry; the bf16 dense-grid rows
at the bf16 gate 2^-7, since each comp rank rounds its partial rows before
the sum), the BAT step also against JAX's own comp-sharded step
(shard_train_step with shard_components=True) at the same mesh.  The
gradients are gathered over the comp ranks before the comparison.

* BAT steps on four paths (fused, two-stage app_k with its selection
  checked equal over the comp group, the dense grid under the blur in
  float32 and bf16 rows, depth TV), TensoRF, CP, one VM variant
  (convolve_positive_only under the blur) and L2G with the error map and
  the background coin; every step's collectives by purpose pinned;
* the BAT Trainer at [2, 2] across the upsample, the mask build with its
  bbox shrink and the masked compacted steps, each step from the JAX
  trainer's state with its jitter: losses, budgets, the pose table and
  render_views against JAX's trainer; the replicas bit-identical by group
  (the factor blocks within a rays group, everything else over the
  world); its checkpoint (rank 0 writes the gathered arrays) restored on
  every rank, into an unsharded trainer and into the JAX package; JAX's
  checkpoint restored into a comp-sharded trainer;
* without ranks: init_vm's blocks of the whole draw (and of the
  reset_on_last_upsample re-draw), the basis rows a rank multiplies, the
  regularisers' shares; an indivisible component count refused by name.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (field_leaves, flatten_field, flatten_l2g_state,
                          flatten_train_state)

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data.base import SceneData as JSceneData
from joint_tensorf_tpu.data import synthetic as jsynthetic
from joint_tensorf_tpu.geometry import lie as jlie, poses as jposes
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.parallel.mesh import make_mesh as jmake_mesh
from joint_tensorf_tpu.parallel.sharding import shard_train_step
from joint_tensorf_tpu.render.renderer import BlurSpec as JBlurSpec
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train import l2g as jl2g
from joint_tensorf_tpu.train import step as jstep
from joint_tensorf_tpu.train.l2g_trainer import L2GTrainer as JL2GTrainer
from joint_tensorf_tpu.train.step import default_scalars
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import to_numpy
from joint_tensorf_tpu_torch.data import load_dataset
from joint_tensorf_tpu_torch.parallel.launch import run_jobs, spawn
from joint_tensorf_tpu_torch.render.renderer import BlurSpec
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train.trainer import (Trainer,
                                                   build_vm_config,
                                                   check_ported)
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, W, R = 4, 12, 12, 24
LR = dict(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3)
VM = dict(density_n_comp=(4, 4, 4), app_n_comp=(4, 4, 4), app_dim=6,
          hidden=8)
B1 = 0.9
BF16_GATE = 2.0 ** -7
SHAPES = ((1, 2), (2, 2))
BLUR = ("uniform-gaussian", 8)

# name: (VMConfig keywords, step config keywords, scalar keywords)
CASES = {
    "fused": ({}, dict(blur=BLUR), dict(use_edge=1.0, tv_density_weight=0.1,
                                        tv_color_weight=0.1)),
    "app_k": ({}, dict(app_k=8), {}),
    "dense_blur": ({}, dict(blur=BLUR, densify_density=True),
                   dict(use_edge=1.0)),
    "dense_bf16": ({}, dict(blur=BLUR, densify_density=True,
                            densify_dtype="bfloat16"), {}),
    "tv_depth": ({}, dict(grid_hw=(4, 6)), dict(tv_depth_weight=0.05)),
    "tensorf": ({}, dict(pose_opt=False), {}),
    "cp": (dict(decomposition="CP"), dict(blur=BLUR),
           dict(tv_density_weight=0.1)),
    "variant": (dict(convolve_positive_only=True), dict(blur=BLUR), {}),
}

BAT = os.path.join(REPO, "configs", "bat_blender_VM.yaml")
COMP4 = ["--arch.tensorf.density_components=[4,4,4]",
         "--arch.tensorf.color_components=[4,4,4]"]
# tests/test_torch_parallel.py's trainer run at 4 components a plane
TRAIN = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--train_schedule.n_voxel_init=64000",
         "--train_schedule.n_voxel_final=262144",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=20",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--train_schedule.upsample_iters=[2]",
         "--train_schedule.update_alphamask_iters=[5]",
         "--tpu.densify_min_samples_per_chip=1000"] + COMP4
TRAIN_STEPS = 9
BUDGETS = ("compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")
MESH22 = ["--tpu.mesh_shape=[2,2]", "--tpu.mesh_axes=[rays,comp]"]

L2G = os.path.join(REPO, "configs", "l2g_bat_blender_VM.yaml")
L2G_SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
             "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
             "--train_schedule.n_voxel_final=13824",
             "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
             "--blur_2d_c2f_kernel_size=15", "--max_iter=12",
             "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
             "--arch.embedding_dim=4", "--arch.layers_warp=[8,8,6]",
             "--arch.skip_warp=[1]", "--error_map_size=8",
             "--train_schedule.upsample_iters=[1]",
             "--train_schedule.update_alphamask_iters=[2]",
             "--train_schedule.shrink_bbox_with_alphamask=false"] + COMP4


# ------------------------------------------------------------ the inputs
def _bat_state(vm_kw):
    """The tiny BAT state (density x 8 as tests/test_torch_train.py; a CP
    field's three density lines x 2 each) and one step's inputs."""
    rng = np.random.default_rng(0)
    jcfg = jvm.VMConfig(**VM, **vm_kw)
    jts = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, (10, 10, 10),
                                 [-1.5] * 3 + [1.5] * 3, V)
    f = jts.params.field
    f.density_planes = [p * 8.0 for p in f.density_planes]
    f.density_lines = [l * (2.0 if f.density_planes == [] else 8.0)
                       for l in f.density_lines]
    gt = jsynthetic.sphere_poses(V)
    noise = (rng.standard_normal((V, 6)) * 0.05).astype(np.float32)
    pose_base = np.asarray(jposes.compose([jlie.se3_to_SE3(noise), gt]))
    focal = 1.1 * W
    intr = np.broadcast_to(np.array(
        [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32),
        (V, 3, 3)).copy()
    inputs = dict(
        pose_base=pose_base, intr=intr,
        intr_inv=np.linalg.inv(intr).astype(np.float32),
        images=rng.random((V, H * W, 3)).astype(np.float32),
        edges=(rng.random((V, H * W)) > 0.7).astype(np.float32),
        view_sel=np.arange(V), ray_idx=rng.permutation(H * W)[:R])
    return jcfg, jts, inputs


def _jax_cfg(step_kw):
    blur = step_kw.get("blur")
    bf16 = step_kw.get("densify_dtype") == "bfloat16"
    return jstep.StepConfig(
        H=H, W=W, n_views=V, rays_per_view=R, n_samples=34,
        pose_opt=step_kw.get("pose_opt", True), use_pose_noise=True,
        blur=JBlurSpec(*blur) if blur else None,
        grid_hw=step_kw.get("grid_hw"), app_k=step_kw.get("app_k"),
        densify_density=step_kw.get("densify_density", False),
        densify_impl="lane" if bf16 else "packed8",
        densify_dtype=step_kw.get("densify_dtype", "float32"))


def _jax_scalars(sc_kw):
    s = dict(LR, c2f_density=0.1, c2f_color=0.25, l1_weight=8e-5,
             edge_factor=1.5, non_edge_factor=0.5, use_edge=0.0,
             tv_depth_weight=0.0, tv_density_weight=0.0,
             tv_color_weight=0.0)
    s.update(sc_kw)
    js = jstep.StepScalars(
        near_far=jnp.array([2.0, 6.0]), view_pe_progress=jnp.float32(1),
        fea_pe_progress=jnp.float32(1), pose_do_step=jnp.float32(1),
        **{k: jnp.float32(v) for k, v in s.items()})
    return s, js


def _jax_grads(new):
    grads = {k: v / (1 - B1) for k, v in field_leaves(
        flatten_field(new.scene_opt.mu)).items() if not k.startswith("aabb")}
    grads["se3_refine"] = np.asarray(new.pose_opt.mu) / (1 - B1)
    return grads


def _jax_step(jcfg, jts, inputs, step_kw, sc_kw, key, mesh_shape=None):
    """JAX's step (unsharded, or comp-sharded at ``mesh_shape``) ->
    (metrics, gradients, jitter, the port's step config, scalars, state
    after)."""
    jsc = _jax_cfg(step_kw)
    s, js = _jax_scalars(sc_kw)
    args = tuple(jnp.asarray(inputs[k]) for k in (
        "pose_base", "intr", "intr_inv", "images", "edges", "view_sel",
        "ray_idx")) + (key, js, None)
    if mesh_shape is None:
        new, jm = jstep.make_train_step(jsc, jcfg, jcfg.shading_head())(
            jts, *args)
    else:
        n = int(np.prod(mesh_shape))
        mesh = jmake_mesh(shape=mesh_shape, axes=("rays", "comp"),
                          devices=jax.devices()[:n])
        raw = jstep.make_train_step(jsc, jcfg, jcfg.shading_head(),
                                    jit=False)
        with mesh:
            new, jm = shard_train_step(raw, mesh, jts,
                                       shard_components=True)(jts, *args)
    jitter = np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                           (V * R, 1)))
    blur = step_kw.get("blur")
    port_cfg = dict(step_kw, H=H, W=W, n_views=V, rays_per_view=R,
                    n_samples=34, blur=BlurSpec(*blur) if blur else None)
    return ({k: float(v) for k, v in jm.items()}, _jax_grads(new), jitter,
            port_cfg, s, flatten_train_state(new))


def _l2g_setup():
    """JAX's L2G trainer with a live warp and one unsharded L2G step with
    the error map and the background coin (tests/test_torch_parallel.py's
    at 4 components a plane); R = 8 rays a view."""
    sc = load_dataset(set_options(L2G, L2G_SMALL), "train", device="cpu")
    jt = JL2GTrainer(jset_options(L2G, L2G_SMALL), JSceneData(
        images=sc.images, poses=sc.poses, intr=sc.intr, intr_inv=sc.intr_inv,
        near_far=sc.near_far, H=sc.H, W=sc.W))
    mlp = list(jt.state.params.warp_mlp)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    Wl, bl = mlp[-1]
    mlp[-1] = (jax.random.normal(k1, Wl.shape) * 0.02,
               jax.random.normal(k2, bl.shape) * 0.02)
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, warp_mlp=mlp))
    Vl, Hl, Wl_, Rl = 4, 16, 16, 8
    S = jt.n_samples
    jcfg = jstep.StepConfig(H=Hl, W=Wl_, n_views=Vl, rays_per_view=Rl,
                            n_samples=S, pose_opt=True, white_bg=False,
                            mask_stride=2)
    step = jl2g.make_l2g_train_step(jcfg, jt.l2g_cfg, jt.vm_cfg, jt.head)
    sc_kw = dict(LR, l1_weight=8e-5, tv_density_weight=0.1,
                 tv_color_weight=0.1, use_edge=1.0, edge_factor=1.5,
                 non_edge_factor=0.5, pose_do_step=1.0)
    js = dataclasses.replace(default_scalars(Vl), **{
        k: jnp.float32(v) for k, v in sc_kw.items()})
    images = sc.images.reshape(Vl, 3, -1).transpose(0, 2, 1)
    edges = (np.random.default_rng(0).uniform(size=(Vl, Hl * Wl_)) > 0.7
             ).astype(np.float32)
    key = jax.random.PRNGKey(22)
    rng, ks = jax.random.split(key)
    kg, kj = jax.random.split(ks)
    draws = (np.asarray(jax.random.uniform(kg, (Vl, 64), minval=1e-10,
                                           maxval=1.0)),
             np.asarray(jax.random.uniform(kj, (2, Vl, Rl))))
    rng_samp, rng_bg = jax.random.split(rng)
    jitter = np.asarray(jax.random.uniform(rng_samp, (Vl * Rl, 1)))
    coin = bool(jax.random.uniform(rng_bg, ()) < 0.5)
    new, jm = step(jt.state, jt.pose_base, jnp.asarray(sc.intr),
                   jnp.asarray(sc.intr_inv), jnp.asarray(images),
                   jnp.asarray(edges), jnp.arange(Vl), jnp.arange(Rl), key,
                   js, None)
    vm_cfg = build_vm_config(set_options(L2G, L2G_SMALL))
    job = dict(
        kind="step", vm_cfg=dataclasses.asdict(vm_cfg),
        l2g_cfg=dataclasses.asdict(jt.l2g_cfg) | {
            "layers_warp": tuple(jt.l2g_cfg.layers_warp),
            "skip_warp": tuple(jt.l2g_cfg.skip_warp)},
        step_cfg=dict(H=Hl, W=Wl_, n_views=Vl, rays_per_view=Rl,
                      n_samples=S, white_bg=False, mask_stride=2),
        scalars=dict(sc_kw, near_far=(2.0, 6.0)),
        state=flatten_l2g_state(jt.state),
        inputs=dict(pose_base=np.asarray(jt.pose_base), intr=sc.intr,
                    intr_inv=sc.intr_inv, images=images, edges=edges,
                    view_sel=np.arange(Vl), ray_idx=np.arange(Rl),
                    jitter=jitter, bg_coin=coin, error_draws=draws))
    return job, {k: float(v) for k, v in jm.items()}, flatten_l2g_state(new)


def _trainer_setup(ckpt_path):
    """JAX's trainer through TRAIN_STEPS iterations from a blob field:
    the state and jitter before each step, the loss and the budgets after
    each schedule update, its state, first view and checkpoint at the
    end."""
    sc = load_dataset(set_options(BAT, TRAIN), "train", device="cpu")
    jt = JTrainer(jset_options(BAT, TRAIN), JSceneData(
        images=sc.images, poses=sc.poses, intr=sc.intr, intr_inv=sc.intr_inv,
        near_far=sc.near_far, H=sc.H, W=sc.W))
    rng = np.random.default_rng(0)
    field = jt.state.params.field
    res = field.resolution()
    inside = []
    for r in res:
        t = np.arange(r) / (r - 1)
        inside.append(((t >= 0.1) & (t <= 0.3)) | ((t >= 0.7) & (t <= 0.9)))
    planes, lines = [], []
    for i in range(3):
        m0, m1 = jvm.MAT_MODE[i]
        p = rng.uniform(0.5, 1.0, (res[m1], res[m0], 4)).astype(np.float32)
        planes.append(jnp.asarray(
            p * (inside[m1][:, None] & inside[m0][None, :])[..., None] * 4.0))
        ax = jvm.VEC_MODE[i]
        l = rng.uniform(0.5, 1.0, (res[ax], 4)).astype(np.float32)
        lines.append(jnp.asarray(l * inside[ax][:, None]))
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, field=dataclasses.replace(
            field, density_planes=planes, density_lines=lines)))
    states, jitters, rows = [], [], []
    first = flatten_train_state(jt.state, jt.pose_base)
    for _ in range(TRAIN_STEPS):
        states.append(flatten_train_state(jt.state))
        _, step_key = jax.random.split(jt.key)
        jitters.append(np.asarray(jax.random.uniform(
            jax.random.split(step_key)[0], (64, 1))))
        jm = jt.train_iteration()
        jt._update_schedule()
        rows.append({"loss": float(jm["loss"]),
                     "budgets": {k: getattr(jt, k) for k in BUDGETS},
                     "resolution": list(jt.resolution)})
        jt.it += 1
    states[0] = first
    rgb, _, _ = jt.render_views(jt.pose_base[:1], jt.intr[:1],
                                jt.intr_inv[:1], chunk=64)
    jckpt.save_checkpoint(ckpt_path, jt)
    return (sc, states, jitters, rows, flatten_train_state(jt.state),
            np.asarray(rgb), jt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX reference, then the three spawns."""
    refs, jobs = {}, []
    for i, (name, (vm_kw, step_kw, sc_kw)) in enumerate(CASES.items()):
        jcfg, jts, inputs = _bat_state(vm_kw)
        m, g, jitter, port_cfg, s, after = _jax_step(
            jcfg, jts, inputs, step_kw, sc_kw, jax.random.PRNGKey(100 + i))
        refs[name] = (m, g, after)
        jobs.append(dict(kind="step", name=name, vm_cfg=dict(VM, **vm_kw),
                         step_cfg=port_cfg, scalars=dict(
                             s, near_far=(2.0, 6.0), pose_do_step=1.0),
                         state=flatten_train_state(jts, inputs["pose_base"]),
                         inputs=dict(inputs, jitter=jitter),
                         stats=name == "app_k"))
        if name == "fused":
            # JAX's own comp-sharded step at both meshes
            refs["jax_sharded"] = {shape: _jax_step(
                jcfg, jts, inputs, step_kw, sc_kw,
                jax.random.PRNGKey(100 + i), shape)[:2] for shape in SHAPES}
    l2g_job, l2g_m, l2g_after = _l2g_setup()
    refs["l2g"] = (l2g_m, None, l2g_after)
    tmp = tmp_path_factory.mktemp("parallel_comp")
    jax_ckpt = str(tmp / "jax.ckpt.npz")
    refs["trainer"] = _trainer_setup(jax_ckpt)
    sc, states, jitters = refs["trainer"][:3]
    path = str(tmp / "model.ckpt.npz")
    trainer_job = dict(kind="trainer", name="trainer", yaml=BAT,
                       args=TRAIN + MESH22, states=states, jitters=jitters,
                       steps=TRAIN_STEPS, render=64, save=path)
    restore_job = dict(kind="trainer", name="restore", yaml=BAT,
                       args=TRAIN + MESH22, steps=0, restore=jax_ckpt)
    axes = ["rays", "comp"]
    out12 = spawn(run_jobs, 2, {"mesh_shape": [1, 2], "mesh_axes": axes,
                                "jobs": jobs + [l2g_job]}, timeout_s=400)
    out22 = spawn(run_jobs, 4, {"mesh_shape": [2, 2], "mesh_axes": axes,
                                "jobs": jobs + [l2g_job, trainer_job,
                                                restore_job]},
                  timeout_s=500)
    swapped = spawn(run_jobs, 4, {"mesh_shape": [2, 2],
                                  "mesh_axes": ["comp", "rays"],
                                  "jobs": jobs[:1]}, timeout_s=300)
    names = [j["name"] for j in jobs] + ["l2g"]

    def by_name(out, names):
        return {n: [r[i] for r in out] for i, n in enumerate(names)}

    return (refs, {(1, 2): by_name(out12, names),
                   (2, 2): by_name(out22, names + ["trainer", "restore"]),
                   "swapped": by_name(swapped, ["fused"])}, path, jax_ckpt)


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(d, (list, tuple)):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(d)


def _same_across_ranks(per_rank, key="state"):
    """The gathered states are the same bits on every rank."""
    first = dict(_leaves(per_rank[0][key]))
    for r in per_rank[1:]:
        got = dict(_leaves(r[key]))
        assert got.keys() == first.keys()
        for k in first:
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


def _close_grads(got: dict, want: dict, tol: float = 1e-4):
    """Each leaf at rtol ``tol`` / atol ``tol`` of its largest entry."""
    assert set(got) == set(want)
    for k in want:
        scale = float(np.nanmax(np.abs(want[k])))
        np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                   atol=tol * scale + 1e-12,
                                   err_msg=f"grad {k}")


def _want_counts(case: str, shape) -> dict:
    """The collectives of one step by purpose: per feature call one
    forward all-reduce over the comp group and, with coordinate gradients
    (not TensoRF), one backward; the comp group's bucket of the basis
    gradient; over a rays axis of more than one rank the NaN counts, the
    gradient bucket and depth TV's gather; the two-stage selection's
    checksum where the step asks for stats."""
    calls = 1 if case in ("fused", "tv_depth", "tensorf", "l2g") else 2
    want = {"comp_forward": calls, "comp_grads": 1}
    if case != "tensorf":
        want["comp_backward"] = calls
    if shape[0] > 1:
        want.update(nan_counts=1, grads=1)
        if case in ("tv_depth", "l2g"):
            want["gather"] = 1
    if case == "app_k":
        want["checksum"] = 1
    return want


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("case", list(CASES))
def test_comp_step_matches_jax(runs, shape, case):
    refs, out, _, _ = runs
    m, g, after = refs[case]
    per_rank = out[shape][case]
    res = per_rank[0]
    tol = BF16_GATE if case == "dense_bf16" else 1e-4
    for k in ("loss", "mse", "psnr"):
        np.testing.assert_allclose(res["metrics"][k], m[k], rtol=tol,
                                   err_msg=k)
    _close_grads(res["grads"], g, tol)
    if case == "tensorf":
        assert not res["grads"]["se3_refine"].any()
    else:
        assert np.abs(g["se3_refine"]).max() > 0
        np.testing.assert_allclose(res["state"]["se3_refine"],
                                   after["se3_refine"],
                                   atol=1e-3 if case == "dense_bf16"
                                   else 1e-5)
    _same_across_ranks(per_rank)
    for r in per_rank:
        assert r["counts"] == _want_counts(case, shape)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
def test_comp_step_matches_jax_comp_sharded_step(runs, shape):
    """JAX's own shard_train_step(..., shard_components=True) at the same
    mesh: the port's comp step agrees with it as with the unsharded one."""
    refs, out, _, _ = runs
    m, g = refs["jax_sharded"][shape]
    res = out[shape]["fused"][0]
    np.testing.assert_allclose(m["loss"], refs["fused"][0]["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(res["metrics"]["loss"], m["loss"], rtol=1e-4)
    _close_grads(res["grads"], g)


def test_the_other_axis_order_lays_ranks_out_as_jax(runs):
    """[comp, rays] of shape [2, 2]: rank c * 2 + r holds comp index c and
    rays index r (JAX reshapes its device list row-major in the order of
    the axes), and the step is the same function."""
    refs, out, _, _ = runs
    per_rank = out["swapped"]["fused"]
    assert [r["coords"] for r in per_rank] == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    assert [r["coords"] for r in out[(2, 2)]["fused"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    m, g, _ = refs["fused"]
    np.testing.assert_allclose(per_rank[0]["metrics"]["loss"], m["loss"],
                               rtol=1e-4)
    _close_grads(per_rank[0]["grads"], g)
    _same_across_ranks(per_rank)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
def test_comp_l2g_step_matches_jax(runs, shape):
    refs, out, _, _ = runs
    m, _, after = refs["l2g"]
    per_rank = out[shape]["l2g"]
    res = per_rank[0]
    np.testing.assert_allclose(res["metrics"]["loss"], m["loss"], rtol=1e-4)
    np.testing.assert_allclose(res["metrics"]["global_alignment"],
                               m["global_alignment"], rtol=1e-3, atol=1e-9)
    got = res["state"]
    for k in ("error_map", "optimised_poses"):
        np.testing.assert_allclose(got[k], after[k], atol=1e-5, err_msg=k)
    assert (got["error_map"] != 1.0).sum() > 0
    pose_mu = after["pose_opt"]["mu"]
    want = {"warp_embedding": pose_mu["warp_embedding"] / (1 - B1)}
    for i, (w, b) in enumerate(pose_mu["warp_mlp"]):
        want[f"warp_mlp.w.{i}"] = w / (1 - B1)
        want[f"warp_mlp.b.{i}"] = b / (1 - B1)
    want.update({k: v / (1 - B1) for k, v in field_leaves(
        after["scene_opt"]["mu"]).items() if not k.startswith("aabb")})
    _close_grads({k: res["grads"][k] for k in want}, want)
    _same_across_ranks(per_rank)
    for r in per_rank:
        assert r["counts"] == _want_counts("l2g", shape)


# ------------------------------------------------------------ the trainer
def test_comp_trainer_matches_jax(runs):
    refs, out, _, _ = runs
    sc, states, jitters, rows, final, rgb, _ = refs["trainer"]
    per_rank = out[(2, 2)]["trainer"]
    hist = per_rank[0]["history"]
    assert len(hist) == TRAIN_STEPS
    seen = set()
    for i, (h, row) in enumerate(zip(hist, rows)):
        np.testing.assert_allclose(h["metrics"]["loss"], row["loss"],
                                   rtol=1e-4, err_msg=f"it {i} vs JAX")
        assert h["budgets"] == row["budgets"], i
        assert h["resolution"] == row["resolution"], i
        cfg = h["config"]
        seen.add((cfg["compact_k"] is not None, cfg["densify_density"],
                  cfg["blur"] is not None))
        for r in per_rank:
            c = r["history"][i]["counts"]
            assert c["grads"] == 1 and c["comp_grads"] == 1, (i, c)
            # the probes of a step's mask refresh add forward reductions
            assert c["comp_forward"] >= c["comp_backward"] >= 1, (i, c)
    # the upsample, the mask build with its shrink, compaction with and
    # without the blur, the dense grid under the blur
    assert hist[-1]["resolution"] != hist[0]["resolution"]
    assert (True, True, True) in seen and (True, False, False) in seen
    # the pose table after the last step, and the first view rendered
    np.testing.assert_allclose(per_rank[0]["state"]["se3_refine"],
                               final["se3_refine"], atol=1e-5)
    for r in per_rank:
        np.testing.assert_allclose(r["render"][0][0], rgb[0], atol=1e-4)
    _same_across_ranks(per_rank)


def test_comp_replicas_are_equal_by_group(runs):
    """The replicated tensors carry the same bits on every rank; the
    factor blocks and their moments on the ranks of one comp index (a
    rays group), and differ between comp indices."""
    _, out, _, _ = runs
    per_rank = out[(2, 2)]["trainer"]
    world = [r["checksums"]["world"] for r in per_rank]
    assert all(w == world[0] for w in world)
    assert "field.basis" in world[0] and "generator" in world[0]
    blocks = {}
    for r in per_rank:
        rays_i, comp_i = r["coords"]
        blocks.setdefault(comp_i, []).append(r["checksums"]["rays"])
        assert "field.density_planes.0" in r["checksums"]["rays"]
        assert "scene_opt.mu.app_lines.2" in r["checksums"]["rays"]
    for comp_i, sums in blocks.items():
        assert len(sums) == 2 and sums[0] == sums[1], comp_i
    assert blocks[0][0] != blocks[1][0]


def test_comp_checkpoint_restores_everywhere(runs):
    """Rank 0 wrote the gathered checkpoint; every rank restored its block
    of it; it restores into an unsharded trainer and into the JAX
    package."""
    refs, out, path, _ = runs
    sc = refs["trainer"][0]
    per_rank = out[(2, 2)]["trainer"]
    for r in per_rank:
        assert r["resumed_it"] == TRAIN_STEPS
    _same_across_ranks(per_rank, "resumed_state")
    want = per_rank[0]["state"]
    for k, a in dict(_leaves(want)).items():
        np.testing.assert_array_equal(dict(_leaves(
            per_rank[0]["resumed_state"]))[k], a, err_msg=k)
    pt = Trainer(set_options(BAT, TRAIN), sc, device="cpu")
    ckpt.restore_checkpoint(path, pt)
    assert pt.mesh is None and pt.it == TRAIN_STEPS
    got = to_numpy(pt.state)
    for k, a in field_leaves(want).items():
        np.testing.assert_array_equal(field_leaves(got)[k], a, err_msg=k)
    np.testing.assert_array_equal(got["se3_refine"], want["se3_refine"])
    jt = refs["trainer"][6]
    jckpt.restore_checkpoint(path, jt)
    jgot = flatten_train_state(jt.state)
    for k, a in field_leaves(want).items():
        np.testing.assert_array_equal(field_leaves(jgot)[k], a, err_msg=k)
    assert jt.it == TRAIN_STEPS and jt.resolution == pt.resolution


def test_jax_checkpoint_restores_into_the_comp_trainer(runs):
    """JAX's checkpoint, restored on 4 ranks at [2, 2]: each rank's
    blocks gathered give JAX's arrays bit for bit."""
    refs, out, _, _ = runs
    final = refs["trainer"][4]
    for r in out[(2, 2)]["restore"]:
        got = r["state"]
        for k, a in field_leaves(final).items():
            np.testing.assert_array_equal(field_leaves(got)[k], a,
                                          err_msg=k)
        for m in ("mu", "nu"):
            for k, a in field_leaves(final["scene_opt"][m]).items():
                if not k.startswith("aabb"):
                    np.testing.assert_array_equal(
                        field_leaves(got["scene_opt"][m])[k], a, err_msg=k)
        np.testing.assert_array_equal(got["se3_refine"],
                                      final["se3_refine"])


# ------------------------------------------------------------ no ranks
def _rank_view(c: int, C: int = 2):
    """Rank c's view of a [1, C] mesh, for the functions that only read
    its coordinates (no process group)."""
    from joint_tensorf_tpu_torch.parallel.mesh import Mesh

    return Mesh(axes=("rays", "comp"), shape=(1, C), rank=c, world_size=C,
                device=torch.device("cpu"), backend="gloo", coords=(0, c))


@pytest.mark.parametrize("cp", [False, True], ids=["vm", "cp"])
def test_init_vm_keeps_the_block_of_the_whole_draw(cp):
    """init_vm under comp draws every factor whole and keeps the rank's
    block, so the sharded run starts from the unsharded run's numbers; so
    does the reset_on_last_upsample re-draw (init_vm with ``prev``), which
    carries the groups it keeps, the head and ``comp``."""
    from joint_tensorf_tpu_torch.models import vm

    cfg = vm.VMConfig(**VM, decomposition="CP" if cp else "VM")
    aabb = [-1.5] * 3 + [1.5] * 3

    def draw(comp, prev=None):
        g = torch.Generator().manual_seed(3)
        return vm.init_vm(cfg, (6, 7, 8), aabb, g, prev=prev, comp=comp,
                          init_app=prev is None)

    whole = draw(None)
    reset_whole = draw(None, prev=whole)
    for c in range(2):
        part = draw(_rank_view(c))
        reset = draw(None, prev=part)
        assert part.comp is reset.comp and part.comp.comp_index == c
        assert reset.shading is part.shading
        for group in ("density_planes", "density_lines", "app_planes",
                      "app_lines"):
            for a, b, ra, rb in zip(
                    getattr(part, group), getattr(whole, group),
                    getattr(reset, group), getattr(reset_whole, group)):
                blk = slice(c * b.shape[-1] // 2, (c + 1) * b.shape[-1] // 2)
                assert torch.equal(a, b[..., blk]), group
                assert torch.equal(ra, rb[..., blk]), group
                if group.startswith("app"):
                    assert torch.equal(ra, a), group
        torch.testing.assert_close(part.basis, whole.basis, rtol=0, atol=0)
        rows = vm.basis_rows(part, cfg)
        per = [n // 2 for n in (cfg.app_n_comp[:1] if cp
                                else cfg.app_n_comp)]
        want, at = [], 0
        for n, k in zip(cfg.app_n_comp, per):
            want.append(whole.basis[at + c * k:at + (c + 1) * k])
            at += n
        assert torch.equal(rows, torch.cat(want))


def test_regularisers_are_shares_of_the_whole():
    """density_L1 and the TV terms under comp: each rank's local sum over
    the global element count; the ranks' shares add up to the unsharded
    term."""
    from joint_tensorf_tpu_torch.models import vm

    cfg = vm.VMConfig(**VM)
    g = torch.Generator().manual_seed(4)
    whole = vm.init_vm(cfg, (6, 7, 8), [-1.5] * 3 + [1.5] * 3, g)
    parts = []
    for c in range(2):
        g = torch.Generator().manual_seed(4)
        parts.append(vm.init_vm(cfg, (6, 7, 8), [-1.5] * 3 + [1.5] * 3, g,
                                comp=_rank_view(c)))
    for fn in (vm.density_L1, vm.tv_loss_density, vm.tv_loss_app):
        torch.testing.assert_close(sum(fn(p) for p in parts), fn(whole),
                                   rtol=1e-6, atol=0)


# ------------------------------------------------------------ refusals
def test_an_indivisible_component_count_is_refused():
    check_ported(set_options(BAT, TRAIN + MESH22))
    with pytest.raises(ValueError, match=r"arch\.tensorf\.color_components"
                       r"\[1\]=6 does not divide by the comp axis \(4\)"):
        check_ported(set_options(BAT, TRAIN + [
            "--tpu.mesh_shape=[1,4]", "--tpu.mesh_axes=[rays,comp]",
            "--arch.tensorf.color_components=[4,6,4]"]))
    with pytest.raises(NotImplementedError, match="heads axis of size 2"):
        check_ported(set_options(BAT, TRAIN + [
            "--tpu.mesh_shape=[2,2]", "--tpu.mesh_axes=[rays,heads]"]))
