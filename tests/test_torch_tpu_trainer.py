"""PyTorch port vs JAX: the trainer's default tpu: path.

* Both trainers on a tiny BAT config with the default tpu: keys and
  S > 128 (40^3 -> 64^3 voxels, S 138 -> 221), each step from the JAX
  trainer's state (density in eight corner boxes, so the masks are
  selective), through the dense-grid
  density and the in-bbox budget under the blur, the dilated blur mask
  once the resolution is final, the upsample after iteration 2, the blur's
  end at iteration 6, and the mask update with its compaction and app_k
  probes (and the bbox shrink) after iteration 8.  After every step and
  schedule update: compact_k_bbox, compact_k_blur, compact_k and app_k_dyn,
  the step's compaction budget, dense-grid and app_k choices and the mask
  that gates it, and the state of the training generator agree, and the
  port reports the blur mask's resolution in the iteration that built it
  (Trainer.blur_mask_built); every step's loss agrees at
  rtol 1e-4 (tests/test_torch_train.py's tolerance), the port fed the
  JAX step's stratified jitter.
* check_ported: each unported tpu: value raises NotImplementedError naming
  the key; configs/bat_blender_VM.yaml's own options pass; densify_dtype
  bfloat16 passes under densify_impl lane (the bf16 reads,
  tests/test_torch_variants.py) and under packed8, where a step equals the
  float32 step bit for bit (the JAX renderer reads the key only under
  lane); float16 raises under lane.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data.base import SceneData as JSceneData
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import train_state_from_numpy
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.train.trainer import Trainer, check_ported
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

CFG = "configs/bat_blender_VM.yaml"
SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--train_schedule.n_voxel_init=64000",
         "--train_schedule.n_voxel_final=262144",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=20",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--train_schedule.upsample_iters=[2]",
         "--train_schedule.update_alphamask_iters=[8]",
         # the dense grid at this size's 64 rays x S samples per step
         "--tpu.densify_min_samples_per_chip=1000"]
BUDGETS = ("compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")


@pytest.fixture(scope="module")
def small_scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def _blob_field(field, rng):
    """The JAX field with density factors that are positive only in eight
    boxes near the grid's corners (fractions 0.1-0.3 and 0.7-0.9 of each
    axis), so that the box shrinks little and rays cross empty space."""
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
    return dataclasses.replace(field, density_planes=planes,
                               density_lines=lines)


def _jax_step_choice(jt):
    """(budget, dense grid, app_k, the mask that gates: "blur", "sharp" or
    None) of the JAX trainer's last step."""
    cfg = jt._step_cfg
    gate = ("blur" if cfg.mask_with_blur else "sharp"
            if cfg.use_alpha_mask and cfg.blur is None else None)
    return cfg.compact_k, cfg.densify_density, cfg.app_k, gate


def _port_step_choice(pt):
    cfg = pt.last_step_config
    mask = pt._step_mask(cfg.blur is not None)
    gate = (None if mask is None else "blur"
            if mask is pt.alpha_mask_blur else "sharp")
    return cfg.compact_k, cfg.densify_density, cfg.app_k, gate


def test_tpu_path_trainer_matches_jax(small_scene):
    sc = small_scene
    jt = JTrainer(jset_options(CFG, SMALL), JSceneData(
        images=sc.images, poses=sc.poses, intr=sc.intr,
        intr_inv=sc.intr_inv, near_far=sc.near_far, H=sc.H, W=sc.W))
    pt = Trainer(set_options(CFG, SMALL), sc, device="cpu")
    assert jt.resolution == pt.resolution == [40, 40, 40]
    assert jt.n_samples == pt.n_samples == 138
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params,
        field=_blob_field(jt.state.params.field, np.random.default_rng(0))))
    pt.state, pt.pose_base = train_state_from_numpy(
        flatten_train_state(jt.state, jt.pose_base), pt.vm_cfg)
    pt._refresh_bbox_k()                   # the JAX pose noise's geometry
    assert pt.compact_k_bbox == jt.compact_k_bbox

    seen, built = set(), 0
    for it in range(11):
        # each step from the JAX state: Adam turns near-zero gradients into
        # +-lr updates whose sign depends on summation order
        # (tests/test_torch_train.py), and the masks are thresholds
        pt.state, _ = train_state_from_numpy(flatten_train_state(jt.state),
                                             pt.vm_cfg)
        _, step_key = jax.random.split(jt.key)
        jitter = np.asarray(jax.random.uniform(jax.random.split(step_key)[0],
                                               (64, 1)))
        jm = jt.train_iteration()
        pm = pt.train_iteration(jitter=torch.as_tensor(jitter))
        assert _port_step_choice(pt) == _jax_step_choice(jt), it
        # the iteration that built the blur mask reports its resolution
        # (the field's, below the cap), every other one None
        mask_res = pt.blur_mask_built
        assert (mask_res is not None) == (pt._blur_mask_built_at == pt.it)
        if mask_res is not None:
            assert mask_res == list(pt.resolution), it
            built += 1
        seen.add(_port_step_choice(pt) + (pt.n_samples,))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"it {it}")
        jt._update_schedule()
        pt._update_schedule()
        for k in BUDGETS:
            assert getattr(pt, k) == getattr(jt, k), (it, k)
        assert pt.rng_np.bit_generator.state == \
            jt.rng_np.bit_generator.state, it
        assert pt.n_samples == jt.n_samples and \
            pt.resolution == jt.resolution, it
        jt.it += 1
        pt.it += 1
    # every branch was taken with K below S: the dense grid under the blur
    # with the in-bbox budget and with the dilated mask's, then mask
    # compaction after the mask update
    assert any(s[1] and s[3] is None and s[0] is not None and s[0] < s[4]
               for s in seen), seen
    assert any(s[1] and s[3] == "blur" and s[0] < s[4] for s in seen), seen
    assert any(not s[1] and s[3] == "sharp" and s[0] is not None
               and s[0] < s[4] for s in seen), seen
    assert pt.alpha_mask is not None
    assert built >= 1


@pytest.mark.parametrize("override", [
    "--tpu.densify_dtype=float16", "--tpu.factor_dtype=float16",
    "--tpu.densify_impl=blocked", "--tpu.plane_scatter=tiled",
    "--+tpu.remat_everything=true"])
def test_unported_tpu_values_raise(override):
    key = override.split("=")[0].lstrip("-+")
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_ported(set_options(CFG, SMALL + [override]))


def test_densify_dtype_bf16_raises_under_lane():
    """The JAX renderer reads densify_dtype only under densify_impl lane
    (its bf16 row reads): the port runs bfloat16 there, and a dtype the
    JAX renderer has no reads for still raises naming the layout."""
    check_ported(set_options(CFG, SMALL + [
        "--tpu.densify_impl=lane", "--tpu.densify_dtype=bfloat16"]))
    with pytest.raises(NotImplementedError,
                       match=r"tpu\.densify_dtype.*densify_impl='lane'"):
        check_ported(set_options(CFG, SMALL + [
            "--tpu.densify_impl=lane", "--tpu.densify_dtype=float16"]))


def test_densify_dtype_bf16_under_packed8_steps_as_float32(small_scene):
    """Under packed8 the JAX renderer computes float32 whatever
    densify_dtype says: the port accepts bfloat16 there, and one step on the
    dense grid equals the float32 step bit for bit."""
    packed8 = SMALL + ["--tpu.densify_impl=packed8"]
    jitter = torch.as_tensor(
        np.random.default_rng(3).uniform(size=(64, 1)).astype(np.float32))
    out = {}
    for dtype in ("float32", "bfloat16"):
        opt = set_options(CFG, packed8 + [f"--tpu.densify_dtype={dtype}"])
        check_ported(opt)
        pt = Trainer(opt, small_scene, device="cpu")
        m = pt.train_iteration(jitter=jitter)
        assert pt.last_step_config.densify_density
        out[dtype] = (float(m["loss"]), {
            k: v.detach().clone()
            for k, v in pt.state.field.named_parameters()},
            pt.state.se3_refine.detach().clone())
    (loss_a, field_a, pose_a), (loss_b, field_b, pose_b) = out.values()
    assert loss_a == loss_b
    assert field_a.keys() == field_b.keys()
    for k in field_a:
        assert torch.equal(field_a[k], field_b[k]), k
    assert torch.equal(pose_a, pose_b)


def test_eval_app_k_is_ported():
    """tpu.eval_app_k caps the appearance of evaluation renders
    (Trainer.render_views); the port runs it at any value."""
    check_ported(set_options(CFG, SMALL + ["--tpu.eval_app_k=64"]))


def test_default_tpu_options_pass():
    opt = set_options(CFG, ["--data.dataset=synthetic"])
    assert opt.tpu.densify_impl == "lane" and opt.tpu.app_k == 64
    check_ported(opt)
