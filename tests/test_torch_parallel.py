"""PyTorch port vs JAX: ray-sharded data parallelism (parallel/), the
counterpart of tests/test_sharding.py, on gloo ranks on the CPU started
by parallel.launch.spawn (two spawns: 2 ranks and 4 ranks, each running
every job below; the children import only the port).

The sharded runs are held against JAX's UNSHARDED step and trainer (which
JAX's own tests hold equal to its sharded ones), at the tolerances of
tests/test_torch_train.py: loss at rtol 1e-4, gradients at 1e-4 of each
leaf's largest entry.  The gradients of JAX's first step are its Adam
moments over (1 - b1) (moments start at zero).  The ranks are held equal
to each other bit for bit.

* one BAT step (blur on, edge loss on) at D = 2 and 4; the same with a
  depth-TV weight on the grid of rays; with NaN targets held unevenly
  by the ranks (the sum/count loss follows the unsharded step; a mean of
  per-rank nanmeans, JAX's pmean, does not); one TensoRF step (no pose
  optimisation); every step makes one gradient all-reduce and one of the
  NaN counts (and one gather with depth TV);
* one L2G step at D = 2 and 4 with the error map and the background
  coin (8 rays a view);
* the BAT Trainer at [2] across the upsample, the mask build with its
  bbox shrink and the masked compacted steps, each step from the JAX
  trainer's state with its jitter: losses and budgets against JAX's
  trainer and the 1-rank port, the replicas bit-identical; its checkpoint
  (rank 0 writes) restored on both ranks, into an unsharded trainer and
  into the JAX package;
* the densify gate keyed on samples per rank: on at one rank, off at [4];
* check_ported taking a comp axis and refusing a component count that
  does not divide by it, make_mesh refusing too few ranks,
  NCCL refusing more ranks than cards, the train CLI refusing a mesh
  config without a launcher.
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
from joint_tensorf_tpu.render.renderer import BlurSpec as JBlurSpec
from joint_tensorf_tpu.train import checkpoint as jckpt
from joint_tensorf_tpu.train import l2g as jl2g
from joint_tensorf_tpu.train import step as jstep
from joint_tensorf_tpu.train.l2g_trainer import L2GTrainer as JL2GTrainer
from joint_tensorf_tpu.train.step import default_scalars
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import (to_numpy,
                                             train_state_from_numpy)
from joint_tensorf_tpu_torch.data import load_dataset
from joint_tensorf_tpu_torch.parallel import mesh as mesh_lib
from joint_tensorf_tpu_torch.parallel.launch import run_jobs, spawn
from joint_tensorf_tpu_torch.train import checkpoint as ckpt
from joint_tensorf_tpu_torch.train import losses
from joint_tensorf_tpu_torch.train.trainer import (Trainer,
                                                   build_vm_config,
                                                   check_ported)
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, W, R = 4, 12, 12, 24
LR = dict(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3)
VM = dict(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4), app_dim=6,
          hidden=8)
B1 = 0.9

# the trainer run: tests/test_torch_tpu_trainer.py's tiny default tpu:
# path (S 138 -> 221), the upsample after it 2, the mask with its bbox
# shrink after it 5, the blur off from it 6
BAT = os.path.join(REPO, "configs", "bat_blender_VM.yaml")
TRAIN = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--train_schedule.n_voxel_init=64000",
         "--train_schedule.n_voxel_final=262144",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=20",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--train_schedule.upsample_iters=[2]",
         "--train_schedule.update_alphamask_iters=[5]",
         "--tpu.densify_min_samples_per_chip=1000"]
TRAIN_STEPS = 9
BUDGETS = ("compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")

L2G = os.path.join(REPO, "configs", "l2g_bat_blender_VM.yaml")
L2G_SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
             "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
             "--train_schedule.n_voxel_final=13824",
             "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
             "--blur_2d_c2f_kernel_size=15", "--max_iter=12",
             "--arch.tensorf.density_components=[3,3,3]",
             "--arch.tensorf.color_components=[4,4,4]",
             "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
             "--arch.embedding_dim=4", "--arch.layers_warp=[8,8,6]",
             "--arch.skip_warp=[1]", "--error_map_size=8",
             "--train_schedule.upsample_iters=[1]",
             "--train_schedule.update_alphamask_iters=[2]",
             "--train_schedule.shrink_bbox_with_alphamask=false"]


# ------------------------------------------------------------ the inputs
def _bat_inputs():
    """The tiny BAT state (density x 8, as tests/test_torch_train.py) and
    one step's inputs."""
    rng = np.random.default_rng(0)
    jcfg = jvm.VMConfig(**VM)
    jts = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, (10, 10, 10),
                                 [-1.5] * 3 + [1.5] * 3, V)
    f = jts.params.field
    f.density_planes = [p * 8.0 for p in f.density_planes]
    f.density_lines = [l * 8.0 for l in f.density_lines]
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


CASES = {
    # name: (step config keywords, scalar keywords)
    "blur_edge": (dict(blur=("uniform-gaussian", 8)), dict(use_edge=1.0)),
    "tv_depth": (dict(grid_hw=(4, 6)), dict(tv_depth_weight=0.05)),
    "nan_target": (dict(blur=("uniform-gaussian", 8)), dict(use_edge=1.0)),
    "tensorf": (dict(pose_opt=False), dict()),
}


def _jax_step(jcfg, jts, inputs, step_kw, sc_kw, key):
    """JAX's unsharded step -> (metrics, gradients, jitter)."""
    from joint_tensorf_tpu_torch.render.renderer import BlurSpec

    blur = step_kw.get("blur")
    jsc = jstep.StepConfig(
        H=H, W=W, n_views=V, rays_per_view=R, n_samples=34,
        pose_opt=step_kw.get("pose_opt", True), use_pose_noise=True,
        blur=JBlurSpec(*blur) if blur else None,
        grid_hw=step_kw.get("grid_hw"))
    s = dict(LR, c2f_density=0.1, c2f_color=0.25, l1_weight=8e-5,
             edge_factor=1.5, non_edge_factor=0.5, use_edge=0.0,
             tv_depth_weight=0.0)
    s.update(sc_kw)
    js = jstep.StepScalars(
        near_far=jnp.array([2.0, 6.0]), tv_density_weight=jnp.float32(0),
        tv_color_weight=jnp.float32(0), view_pe_progress=jnp.float32(1),
        fea_pe_progress=jnp.float32(1), pose_do_step=jnp.float32(1),
        **{k: jnp.float32(v) for k, v in s.items()})
    fn = jstep.make_train_step(jsc, jcfg, jcfg.shading_head())
    new, jm = fn(jts, *(jnp.asarray(inputs[k]) for k in (
        "pose_base", "intr", "intr_inv", "images", "edges", "view_sel",
        "ray_idx")), key, js, None)
    grads = {k: v / (1 - B1) for k, v in field_leaves(
        flatten_field(new.scene_opt.mu)).items() if not k.startswith("aabb")}
    grads["se3_refine"] = np.asarray(new.pose_opt.mu) / (1 - B1)
    jitter = np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                           (V * R, 1)))
    port_cfg = dict(H=H, W=W, n_views=V, rays_per_view=R, n_samples=34,
                    pose_opt=jsc.pose_opt,
                    blur=BlurSpec(*blur) if blur else None,
                    grid_hw=step_kw.get("grid_hw"))
    return ({k: float(v) for k, v in jm.items()}, grads, jitter, port_cfg,
            s, flatten_train_state(new))


def _l2g_setup():
    """JAX's L2G trainer with a live warp (tests/test_torch_l2g.py) and one
    unsharded L2G step with the error map and the background coin; R = 8
    rays a view (divisible by 2 and 4)."""
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


def _trainer_setup():
    """JAX's trainer through TRAIN_STEPS iterations from the blob field of
    tests/test_torch_tpu_trainer.py: the state and jitter before each
    step, the loss, and the budgets after each schedule update."""
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
        p = rng.uniform(0.5, 1.0, (res[m1], res[m0], 3)).astype(np.float32)
        planes.append(jnp.asarray(
            p * (inside[m1][:, None] & inside[m0][None, :])[..., None] * 4.0))
        ax = jvm.VEC_MODE[i]
        l = rng.uniform(0.5, 1.0, (res[ax], 3)).astype(np.float32)
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
    return sc, states, jitters, rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX reference, then the two spawns."""
    jcfg, jts, inputs = _bat_inputs()
    base = flatten_train_state(jts, inputs["pose_base"])
    refs, jobs = {}, []
    for i, (name, (step_kw, sc_kw)) in enumerate(CASES.items()):
        x = dict(inputs)
        if name == "nan_target":
            # NaN targets only in the first rays of view 0: rank 0's block
            x["images"] = x["images"].copy()
            x["images"][0, x["ray_idx"][:4]] = np.nan
        m, g, jitter, port_cfg, s, after = _jax_step(
            jcfg, jts, x, step_kw, sc_kw, jax.random.PRNGKey(100 + i))
        refs[name] = (m, g, after)
        jobs.append(dict(kind="step", name=name, vm_cfg=VM,
                         step_cfg=port_cfg, scalars=dict(
                             s, near_far=(2.0, 6.0), pose_do_step=1.0),
                         state=base, inputs=dict(x, jitter=jitter)))
    l2g_job, l2g_m, l2g_after = _l2g_setup()
    refs["l2g"] = (l2g_m, None, l2g_after)
    sc, states, jitters, rows = _trainer_setup()
    refs["trainer"] = (sc, states, jitters, rows)
    path = str(tmp_path_factory.mktemp("parallel") / "model.ckpt.npz")
    trainer_job = dict(kind="trainer", name="trainer", yaml=BAT,
                       args=TRAIN + ["--tpu.mesh_shape=[2]"],
                       states=states, jitters=jitters, steps=TRAIN_STEPS,
                       save=path)
    # the densify gate: at the first step's samples (64 rays x S 138) one
    # rank densifies, a rank of [4] evaluates a quarter of them
    thresh = 64 * 138 // 2
    gate_job = dict(kind="trainer", name="gate", yaml=BAT, steps=1,
                    args=TRAIN + [f"--tpu.densify_min_samples_per_chip="
                                  f"{thresh}", "--tpu.mesh_shape=[4]"])
    out2 = spawn(run_jobs, 2, {"mesh_shape": [2],
                               "jobs": jobs + [l2g_job, trainer_job]},
                 timeout_s=400)
    out4 = spawn(run_jobs, 4, {"mesh_shape": [4],
                               "jobs": [jobs[0], jobs[1], jobs[3], l2g_job,
                                        gate_job]}, timeout_s=400)
    names2 = [j["name"] for j in jobs] + ["l2g", "trainer"]
    names4 = ["blur_edge", "tv_depth", "tensorf", "l2g", "gate"]
    return (refs, {2: {n: [r[i] for r in out2] for i, n in
                       enumerate(names2)},
                   4: {n: [r[i] for r in out4] for i, n in
                       enumerate(names4)}}, path, thresh)


def _same_across_ranks(per_rank, key="state"):
    def leaves(d, prefix=""):
        if isinstance(d, dict):
            for k, v in d.items():
                yield from leaves(v, f"{prefix}.{k}")
        elif isinstance(d, (list, tuple)):
            for i, v in enumerate(d):
                yield from leaves(v, f"{prefix}[{i}]")
        else:
            yield prefix, np.asarray(d)

    first = dict(leaves(per_rank[0][key]))
    for r in per_rank[1:]:
        got = dict(leaves(r[key]))
        assert got.keys() == first.keys()
        for k in first:
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


def _close_grads(got: dict, want: dict):
    """Each leaf at rtol 1e-4 / atol 1e-4 of its largest finite entry;
    NaNs (a NaN target's rays) in the same places."""
    assert set(got) == set(want)
    for k in want:
        scale = float(np.nanmax(np.abs(want[k])))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale + 1e-12,
                                   err_msg=f"grad {k}")


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", ["blur_edge", "tv_depth", "tensorf"])
def test_sharded_step_matches_jax(runs, d, case):
    refs, out, _, _ = runs
    m, g, after = refs[case]
    per_rank = out[d][case]
    res = per_rank[0]
    for k in ("loss", "mse", "psnr"):
        np.testing.assert_allclose(res["metrics"][k], m[k], rtol=1e-4,
                                   err_msg=k)
    _close_grads({k: v for k, v in res["grads"].items()}, g)
    if case == "tensorf":
        assert not res["grads"]["se3_refine"].any()
    else:
        assert np.abs(g["se3_refine"]).max() > 0
        np.testing.assert_allclose(res["state"]["se3_refine"],
                                   after["se3_refine"], atol=1e-5)
    _same_across_ranks(per_rank)
    # one gradient all-reduce and one of the NaN counts; a gather only
    # with the depth-TV weight
    for r in per_rank:
        want = {"grads": 1, "nan_counts": 1}
        if case == "tv_depth":
            want["gather"] = 1
        assert r["counts"] == want


def test_nan_targets_follow_the_unsharded_step(runs):
    refs, out, _, _ = runs
    m, g, _ = refs["nan_target"]
    res = out[2]["nan_target"][0]
    assert np.isfinite(m["loss"])
    for k in ("loss", "mse", "psnr"):
        np.testing.assert_allclose(res["metrics"][k], m[k], rtol=1e-4,
                                   err_msg=k)
    # both packages carry the NaN targets' rays into NaN gradients
    assert any(np.isnan(v).any() for v in g.values())
    _close_grads(res["grads"], g)
    _same_across_ranks(out[2]["nan_target"])


def test_mean_of_shard_nanmeans_differs_from_the_sum_over_count():
    """JAX's sharded step pmeans per-shard nanmeans; where the shards hold
    different numbers of NaNs that is not the unsharded nanmean.  The
    port's sum/count form is."""
    rng = np.random.default_rng(5)
    pred = torch.as_tensor(rng.random((2, 8, 3)), dtype=torch.float32)
    target = pred + torch.as_tensor(rng.random((2, 8, 3)),
                                    dtype=torch.float32)
    target[0, :3] = float("nan")              # shard 0 holds the NaNs
    want = float(losses.mse(pred, target))
    halves = [(pred[:, :4], target[:, :4]), (pred[:, 4:], target[:, 4:])]
    pmean = np.mean([float(losses.mse(p, t)) for p, t in halves])
    sums = [losses.mse_sum_count(p, t) for p, t in halves]
    port = float(sum(s for s, _ in sums) / sum(c for _, c in sums))
    np.testing.assert_allclose(port, want, rtol=1e-6)
    assert abs(pmean - want) > 1e-3 * want


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_l2g_step_matches_jax(runs, d):
    refs, out, _, _ = runs
    m, _, after = refs["l2g"]
    per_rank = out[d]["l2g"]
    res = per_rank[0]
    np.testing.assert_allclose(res["metrics"]["loss"], m["loss"], rtol=1e-4)
    np.testing.assert_allclose(res["metrics"]["global_alignment"],
                               m["global_alignment"], rtol=1e-3, atol=1e-9)
    got = res["state"]
    for k in ("error_map", "optimised_poses"):
        np.testing.assert_allclose(got[k], after[k], atol=1e-5, err_msg=k)
    assert (got["error_map"] != 1.0).sum() > 0
    # the gradients, as the first step's moments
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
        assert r["counts"] == {"grads": 1, "nan_counts": 1, "gather": 1}


# ------------------------------------------------------------ the trainer
def test_sharded_trainer_matches_jax_and_one_rank(runs):
    refs, out, _, _ = runs
    sc, states, jitters, rows = refs["trainer"]
    per_rank = out[2]["trainer"]
    # the 1-rank port, each step from the same JAX state
    pt = Trainer(set_options(BAT, TRAIN), sc, device="cpu")
    one = []
    for i in range(TRAIN_STEPS):
        st, pose_base = train_state_from_numpy(states[i], pt.vm_cfg)
        pt.state = st
        if pose_base is not None:
            pt.pose_base = pose_base
            pt._refresh_bbox_k()
        m = pt.train_iteration(jitter=torch.as_tensor(jitters[i]))
        pt._update_schedule()
        one.append((float(m["loss"]), {k: getattr(pt, k) for k in BUDGETS}))
        pt.it += 1
    hist = per_rank[0]["history"]
    assert len(hist) == TRAIN_STEPS
    seen = set()
    for i, (h, row, (loss1, budgets1)) in enumerate(zip(hist, rows, one)):
        np.testing.assert_allclose(h["metrics"]["loss"], row["loss"],
                                   rtol=1e-4, err_msg=f"it {i} vs JAX")
        np.testing.assert_allclose(h["metrics"]["loss"], loss1, rtol=1e-5,
                                   err_msg=f"it {i} vs one rank")
        assert h["budgets"] == row["budgets"] == budgets1, i
        assert h["resolution"] == row["resolution"], i
        cfg = h["config"]
        seen.add((cfg["compact_k"] is not None, cfg["densify_density"],
                  cfg["blur"] is not None))
        for r in per_rank:
            c = r["history"][i]["counts"]
            assert c["grads"] == 1 and c.get("nan_counts", 0) <= 1, (i, c)
            assert set(c) <= {"grads", "nan_counts", "gather", "broadcast"}
    # the upsample, the mask build with its shrink, compaction with and
    # without the blur, the dense grid under the blur
    assert hist[-1]["resolution"] != hist[0]["resolution"]
    assert (True, True, True) in seen and (True, False, False) in seen
    _same_across_ranks(per_rank)
    assert per_rank[0]["checksums"] == per_rank[1]["checksums"]


def test_sharded_checkpoint_restores_everywhere(runs):
    """Rank 0 wrote the checkpoint; both ranks restored it; it restores
    into an unsharded trainer and into the JAX package."""
    refs, out, path, _ = runs
    sc = refs["trainer"][0]
    per_rank = out[2]["trainer"]
    for r in per_rank:
        assert r["resumed_it"] == TRAIN_STEPS
    _same_across_ranks(per_rank, "resumed_state")
    want = per_rank[0]["state"]
    pt = Trainer(set_options(BAT, TRAIN), sc, device="cpu")
    ckpt.restore_checkpoint(path, pt)
    assert pt.mesh is None and pt.it == TRAIN_STEPS
    got = to_numpy(pt.state)
    for k, a in field_leaves(want).items():
        np.testing.assert_array_equal(field_leaves(got)[k], a, err_msg=k)
    np.testing.assert_array_equal(got["se3_refine"], want["se3_refine"])
    jt = JTrainer(jset_options(BAT, TRAIN), JSceneData(
        images=sc.images, poses=sc.poses, intr=sc.intr, intr_inv=sc.intr_inv,
        near_far=sc.near_far, H=sc.H, W=sc.W))
    jckpt.restore_checkpoint(path, jt)
    jgot = flatten_train_state(jt.state)
    for k, a in field_leaves(want).items():
        np.testing.assert_array_equal(field_leaves(jgot)[k], a, err_msg=k)
    assert jt.it == TRAIN_STEPS and jt.resolution == pt.resolution


def test_densify_gate_flips_on_rays_per_rank(runs):
    refs, out, _, thresh = runs
    sc = refs["trainer"][0]
    one = Trainer(set_options(BAT, TRAIN + [
        f"--tpu.densify_min_samples_per_chip={thresh}"]), sc, device="cpu")
    assert one._samples_per_chip(16) == 64 * 138
    assert one._step_config(16, None, None).densify_density
    for r in out[4]["gate"]:
        cfg = r["history"][0]["config"]
        assert cfg["rays_per_view"] == 16 and cfg["n_samples"] == 138
        assert not cfg["densify_density"]


# ------------------------------------------------------------ refusals
def test_check_ported_refuses_the_comp_axis():
    """The comp axis is ported: [4,2] runs with counts that divide by 2;
    TRAIN's 3 density components a plane do not, and are refused by name
    (tests/test_torch_parallel_comp.py runs the layout)."""
    check_ported(set_options(BAT, TRAIN + ["--tpu.mesh_shape=[4,1]",
                                           "--tpu.mesh_axes=[rays,comp]"]))
    check_ported(set_options(BAT, TRAIN + [
        "--tpu.mesh_shape=[4,2]", "--tpu.mesh_axes=[rays,comp]",
        "--arch.tensorf.density_components=[4,4,4]"]))
    with pytest.raises(ValueError, match=r"arch\.tensorf\.density_components"
                       r"\[0\]=3 does not divide by the comp axis \(2\)"):
        check_ported(set_options(BAT, TRAIN + [
            "--tpu.mesh_shape=[4,2]", "--tpu.mesh_axes=[rays,comp]"]))


def test_make_mesh_needs_the_ranks():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match=r"needs 2 ranks but 1 is running"
                       r".*torch\.distributed\.run --nproc_per_node=2"):
        mesh_lib.make_mesh((2,), ("rays",))


def test_nccl_refuses_more_ranks_than_cards(tmp_path):
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="one card per rank"):
        mesh_lib.initialize_distributed(f"file://{tmp_path}/store", n, 0,
                                        backend="nccl", device="cuda")
    assert not torch.distributed.is_initialized()


def test_train_cli_refuses_a_mesh_without_a_launcher(tmp_path):
    from joint_tensorf_tpu_torch.train.__main__ import main

    with pytest.raises(ValueError, match="needs 16 ranks"):
        main([f"--yaml={REPO}/configs/bat_blender_VM_pod16.yaml",
              "--device=cpu", "--data.dataset=synthetic",
              "--data.image_size=[16,16]", "--data.n_views=4",
              f"--output_root={tmp_path}"])
