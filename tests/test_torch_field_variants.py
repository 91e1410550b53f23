"""PyTorch port vs JAX: the VM variants and the render / pose options the
port refused before (tests/torch_field_parity.py holds the comparisons and
their tolerances).

* each of BAT's blur-path variants (abs_components,
  component_wise_feature2density, plane_feature2density,
  convolve_plane_only, convolve_positive_only, the latter with
  ignore_negative_split) on signed factors under the blur: render_rays
  asked for the dense grid and the two-stage appearance against JAX's,
  and one train step on the default path (fused or separate samples, as
  the variant allows); convolve_positive_only falls back to the factored
  density, its samples plain gathers; ignore_negative_split alone changes
  nothing;
* arch.shading.predict_density (MLP_Fea_WeakView_Density): the render,
  which ignores the dense grid and app_k asked for, and one step; K1
  receives the colours pre-multiplied by the validity and no threshold;
* detach_viewdirs false (MLP_Fea) and detach_xyz false (MLP_PE): render
  and step, the pose gradient then carrying the head's path;
* nerf.sample_stratified false: render and step without jitter;
* optim.sched_pose.lr_pose_schedule (with the LambdaLR type, with no
  type, with ExponentialLR at lr_pose 0) and warmup: the pose lr of each
  iteration equal to the JAX trainer's;
* one CPU step's row-scatter calls (K3 on the card), summed density
  samples and concatenated appearance samples forward and backward (K6
  and K7 on the card) for each variant, the
  density head, CP (plain and component-wise) and SH, with and without
  the dense grid, app_k and the blur, equal chip_smoke.expected_launches,
  and so do a step's whose fused samples run in chunks (_PROD_BWD_CHUNK
  lowered to 200);
* check_ported accepts every value it refused before and a mesh of the
  rays or the comp layout, refuses a component count that does not
  divide by the comp axis (ValueError) and an axis of another name;
  predict_density without the density head (or the head without it) is
  a ValueError;
* render_views and three test-time steps (JAX's draws) on the density
  head, CP, SH and MLP_PE with an alpha mask: renders at atol 1e-4, the
  refined pose at 1e-5, the loss at rtol 1e-4; JAX's evaluate.py
  test-time config (mlp_predict_density off) fails on the density head,
  the port's passes the config's flag; the pose-gradient maps of a CP
  field equal JAX's within 1e-4 of each map's max, and with the density
  head JAX's fail where the port's render the head's density;
* the JAX quirks the port copies: build_vm_config compares the
  arch.shading dict with "RGB" (so RGB takes arch.shading.app_dim, and
  refuses any but 3); the app_k probe applies feature2density on top of a
  component-wise activated feature (the printed gate quantile equals
  JAX's, and differs from the renderer's density); under predict_density
  the alpha mask is built from the density factors, which the render
  does not read.
"""
import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import _jscene, one_torch_thread  # noqa: F401
from test_torch_test_optim import _Counter
from test_torch_tpu_trainer import CFG, SMALL
from torch_field_parity import (jax_train_state, render_parity,
                                step_parity)
from torch_parity import flatten_field, flatten_train_state

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.models import vm as jvm
from joint_tensorf_tpu.models.alpha_mask import \
    update_alpha_mask as jupdate_mask
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu.train.trainer import build_vm_config as jbuild
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import (field_from_numpy,
                                             train_state_from_numpy)
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.models import alpha_mask as am
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import sampling
from joint_tensorf_tpu_torch.render import renderer
from joint_tensorf_tpu_torch.render.renderer import BlurSpec
from joint_tensorf_tpu_torch.train.step import (StepConfig, StepScalars,
                                                init_train_state, train_step)
from joint_tensorf_tpu_torch.train.trainer import (Trainer, build_vm_config,
                                                   check_ported)
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

TINY = dict(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4), app_dim=6,
            hidden=8)


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return jvm.VMConfig(**kw), vm.VMConfig(**kw)


# the activation variants apply softplus(x - 10) per component, which
# leaves a fresh field empty: their cases shift by -4 instead
VARIANTS = {
    "abs_components": dict(abs_components=True),
    "component_wise_feature2density": dict(
        component_wise_feature2density=True, density_shift=-4.0),
    "plane_feature2density": dict(plane_feature2density=True,
                                  density_shift=-4.0),
    "convolve_plane_only": dict(convolve_plane_only=True),
    "convolve_positive_only": dict(convolve_positive_only=True),
    "convolve_positive_only_ignore_negative_split": dict(
        convolve_positive_only=True, ignore_negative_split=True),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_render_and_step_match_jax(name):
    jcfg, pcfg = _cfgs(**VARIANTS[name])
    kw = dict(densify_density=True, app_k=6)
    render_parity(jcfg, pcfg, kw, kw, signed=True)
    step_parity(jcfg, pcfg, n_steps=1, signed=True)


def _port_render(pcfg, rcfg_kw, grads_of=None, jitter_seed=0):
    """The port's render of a few rays through a signed field under the
    blur, the stratified jitter drawn from ``jitter_seed`` (rgb, and the
    gradients of its sum w.r.t. ``grads_of``: "rays" or None)."""
    ts = jax_train_state(jvm.VMConfig(**dataclasses.asdict(pcfg)),
                         signed=True)
    field = field_from_numpy(flatten_field(ts.params.field), pcfg)
    gen = torch.Generator().manual_seed(0)
    c = torch.tensor([[0.0, 0.0, -4.0]]).repeat(12, 1).requires_grad_()
    d = (torch.tensor([[0.0, 0.0, 1.0]]) + 0.15 * torch.randn(
        (12, 3), generator=gen)).requires_grad_()
    rgb, _, _ = renderer.render_rays(
        field, pcfg, renderer.RenderConfig(n_samples=40, is_train=True,
                                           **rcfg_kw), c, d, (2.0, 6.0),
        blur=renderer.BlurSpec("uniform-gaussian", 8), c2f_density=0.2,
        c2f_color=0.3, ray_jitter=torch.rand(
            (12, 1), generator=torch.Generator().manual_seed(jitter_seed)))
    if grads_of is None:
        return rgb.detach(), None
    return rgb.detach(), torch.autograd.grad(rgb.sum(), [c, d])


def test_ignore_negative_split_alone_changes_nothing():
    """ignore_negative_split acts only inside convolve_positive_only's
    split: alone it leaves the fused sample and its render as they are."""
    _, plain = _cfgs()
    flag = dataclasses.replace(plain, ignore_negative_split=True)
    assert vm.can_fuse_features(flag) and vm.can_densify(flag)
    assert torch.equal(_port_render(plain, {})[0], _port_render(flag, {})[0])


def test_positive_only_falls_back_to_the_factored_density(monkeypatch):
    """convolve_positive_only under the blur: no dense grid, no fused
    sample; the density's plane and line samples are plain gathers (no
    sample_planeline_prod for the density); the appearance is one
    concatenated sample (K7 on the card)."""
    _, pcfg = _cfgs(convolve_positive_only=True)
    assert not vm.can_densify(pcfg) and not vm.can_fuse_features(pcfg)
    calls = {"grid": 0, "prod": 0, "cat": 0}

    def count(key, name):
        fn = getattr(vm, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(vm, name, wrapped)

    count("grid", "compute_density_grid")
    count("prod", "sample_planeline_prod")
    count("cat", "sample_planeline_prod_cat")
    _port_render(pcfg, dict(densify_density=True))
    assert calls == {"grid": 0, "prod": 0, "cat": 1}


def test_predict_density_render_and_step_match_jax(monkeypatch):
    jcfg, pcfg = _cfgs(shading_mode="MLP_Fea_WeakView_Density")
    seen = []
    composite = renderer.composite

    def spy(alpha, rgb, z, thres=float("-inf")):
        seen.append((rgb.detach().clone(), thres))
        return composite(alpha, rgb, z, thres)

    monkeypatch.setattr(renderer, "composite", spy)
    kw = dict(mlp_predict_density=True, densify_density=True, app_k=6)
    render_parity(jcfg, pcfg, kw, kw)
    # one composite, ungated, its colours zero outside the valid samples
    (rgb, thres), = seen
    assert thres == float("-inf")
    assert (rgb.abs().sum(-1) == 0).any() and (rgb.abs().sum(-1) > 0).any()
    step_parity(jcfg, pcfg, n_steps=1, j_kw=dict(mlp_predict_density=True),
                p_kw=dict(mlp_predict_density=True))


@pytest.mark.parametrize("head,flag", [("MLP_Fea", "detach_viewdirs"),
                                       ("MLP_PE", "detach_xyz")])
def test_detach_flags_off_match_jax(head, flag):
    jcfg, pcfg = _cfgs(shading_mode=head)
    kw = {flag: False}
    render_parity(jcfg, pcfg, kw, kw)
    step_parity(jcfg, pcfg, n_steps=1, j_kw=kw, p_kw=kw)


def test_detach_flags_move_the_pose_gradient():
    """With the points and view directions attached, the head's path adds
    to the rays' gradients (the pose gradient's source); the render is the
    same."""
    _, pcfg = _cfgs(shading_mode="MLP_PE")
    out = {off: _port_render(pcfg, dict(detach_xyz=not off,
                                        detach_viewdirs=not off), "rays")
           for off in (False, True)}
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert not torch.allclose(a, b)


def test_unstratified_render_and_step_match_jax():
    """The samples start at the near plane, inside the box (the rays enter
    it at 1.95-3.0), not on its face."""
    jcfg, pcfg = _cfgs()
    kw, near_far = dict(stratified=False), (3.05, 6.0)
    render_parity(jcfg, pcfg, kw, kw, near_far=near_far)
    # the jitter is not read
    assert torch.equal(_port_render(pcfg, kw, jitter_seed=1)[0],
                       _port_render(pcfg, kw)[0])
    assert not torch.equal(_port_render(pcfg, {}, jitter_seed=1)[0],
                           _port_render(pcfg, {})[0])
    step_parity(jcfg, pcfg, n_steps=2, j_kw=kw, p_kw=kw, near_far=near_far)


@pytest.fixture(scope="module")
def small_scene():
    return synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")


def _pair(scene, args):
    jt = JTrainer(jset_options(CFG, SMALL + args), _jscene(scene))
    pt = Trainer(set_options(CFG, SMALL + args), scene, device="cpu")
    pt.state, pt.pose_base = train_state_from_numpy(
        flatten_train_state(jt.state, jt.pose_base), pt.vm_cfg)
    return jt, pt


@pytest.mark.parametrize("args", [
    ["--optim.sched_pose.type=LambdaLR",
     "--+optim.sched_pose.lr_pose_schedule=[0.002,0.0005,0.0001]"],
    ["--optim.sched_pose.type=null",
     "--+optim.sched_pose.lr_pose_schedule=[0.002,0.0001]",
     "--optim.warmup_pose=7"],
    ["--optim.lr_pose=0", "--optim.sched_pose.type=ExponentialLR",
     "--+optim.sched_pose.lr_pose_schedule=[0.003,0.001]"]])
def test_pose_lambda_schedule_matches_jax(small_scene, args):
    args = args + ["--max_iter=40"]
    jt = JTrainer(jset_options(CFG, SMALL + args), _jscene(small_scene))
    pt = Trainer(set_options(CFG, SMALL + args), small_scene, device="cpu")
    want, got = [], []
    for it in range(0, 41, 3):
        jt.it = pt.it = it
        want.append(jt._lr_pose())
        got.append(pt._lr_pose())
    assert got == pytest.approx(want, rel=1e-12)
    assert len(set(got)) > 3 and max(got) > 0
    pt.it = 5
    m = pt.train_iteration()
    assert np.isfinite(float(m["loss"]))


FORMERLY_REFUSED = [
    "--arch.shading.model=MLP_Fea4", "--arch.shading.model=MLP_PE",
    "--arch.shading.model=MLP", "--arch.shading.model=MLP_Albedo",
    "--arch.shading.model=GaRF", "--arch.shading.model=SH",
    "--arch.shading.model=RGB",
    "--arch.shading.detach_viewdirs=false",
    "--arch.shading.detach_xyz=false",
    "--arch.tensorf.model=BAT_CP", "--arch.tensorf.model=TensorCP",
    "--arch.abs_components=true",
    "--arch.component_wise_feature2density=true",
    "--arch.plane_feature2density=true", "--arch.convolve_plane_only=true",
    "--arch.convolve_positive_only=true",
    "--arch.ignore_negative_split=true", "--nerf.sample_stratified=false",
    "--optim.sched_pose.type=LambdaLR",
    "--+optim.sched_pose.lr_pose_schedule=[0.001,0.0005]"]


@pytest.mark.parametrize("override", FORMERLY_REFUSED)
def test_check_ported_accepts_the_formerly_refused(override):
    check_ported(set_options(CFG, SMALL + [override]))


def test_check_ported_accepts_predict_density_and_refuses_the_mesh():
    check_ported(set_options(CFG, SMALL + [
        "--arch.shading.model=MLP_Fea_WeakView_Density",
        "--+arch.shading.predict_density=true"]))
    # the rays and comp layouts of a mesh run (tests/test_torch_parallel.py,
    # tests/test_torch_parallel_comp.py); a component count that does not
    # divide by the comp axis, and an axis other than rays and comp, are
    # refused
    check_ported(set_options(CFG, SMALL + ["--tpu.mesh_shape=[16]"]))
    comp = ["--tpu.mesh_shape=[8,2]", "--tpu.mesh_axes=[rays,comp]"]
    check_ported(set_options(CFG, SMALL + comp + [
        "--arch.tensorf.density_components=[4,4,4]"]))
    with pytest.raises(ValueError, match=r"density_components\[0\]=3 does "
                       r"not divide by the comp axis \(2\) of "
                       r"tpu\.mesh_shape"):
        check_ported(set_options(CFG, SMALL + comp))
    with pytest.raises(NotImplementedError, match=r"tpu\.mesh_shape.*heads"):
        check_ported(set_options(CFG, SMALL + [
            "--tpu.mesh_shape=[8,2]", "--tpu.mesh_axes=[rays,heads]"]))
    for bad in (["--arch.shading.model=MLP_Fea_WeakView_Density"],
                ["--+arch.shading.predict_density=true"]):
        with pytest.raises(ValueError, match="predict_density"):
            check_ported(set_options(CFG, SMALL + bad))


def test_rgb_quirk_needs_app_dim_3(small_scene):
    """JAX's build_vm_config compares the arch.shading dict with "RGB"
    (never equal): the RGB head gets arch.shading.app_dim, which must be
    3."""
    rgb = ["--arch.shading.model=RGB"]          # SMALL's app_dim is 6
    assert jbuild(jset_options(CFG, SMALL + rgb)).app_dim == 6
    assert build_vm_config(set_options(CFG, SMALL + rgb)).app_dim == 6
    with pytest.raises(AssertionError):
        jbuild(jset_options(CFG, SMALL + rgb)).shading_head()
    with pytest.raises(ValueError, match="app_dim 3"):
        Trainer(set_options(CFG, SMALL + rgb), small_scene, device="cpu")
    ok = rgb + ["--arch.shading.app_dim=3"]
    assert build_vm_config(set_options(CFG, SMALL + ok)).app_dim == 3
    pt = Trainer(set_options(CFG, SMALL + ok), small_scene, device="cpu")
    assert not any(k.startswith("shading") for k in pt.state.scene_opt.mu)
    assert np.isfinite(float(pt.train_iteration()["loss"]))


def _scale_density(jt, pt):
    """Raise the density factors of both trainers alike, so that probes
    and masks see a non-empty field."""
    f = jt.state.params.field
    f.density_planes = [p * 6.0 for p in f.density_planes]
    f.density_lines = [l * 6.0 for l in f.density_lines]
    with torch.no_grad():
        for p in list(pt.state.field.density_planes) + list(
                pt.state.field.density_lines):
            p.mul_(6.0)


def test_probe_quirk_double_activation(small_scene, capsys):
    """Under component_wise_feature2density the app_k probe applies
    feature2density to the (activated) feature, as JAX's does; the
    renderer and the mask build do not."""
    args = ["--arch.component_wise_feature2density=true", "--tpu.app_k=1",
            "--tpu.app_k_max=1024"]
    jt, pt = _pair(small_scene, args)
    _scale_density(jt, pt)
    capsys.readouterr()
    kj = jt._probe_app_k()
    jline = capsys.readouterr().out
    kp = pt._probe_app_k()
    pline = capsys.readouterr().out
    assert kj == kp and kp is not None
    assert jline.strip() == pline.strip() and "gate quantile" in pline
    coords = tuple(torch.linspace(-0.9, 0.9, 50) for _ in range(3))
    feat = vm.compute_density_feature(pt.state.field, pt.vm_cfg, coords)
    assert not torch.allclose(vm.feature2density(pt.vm_cfg, feat), feat)


def test_predict_density_quirk_mask_reads_the_density_factors(small_scene):
    """Under predict_density the alpha mask (and the probes) read the
    density factors, which the head's density does not use: the masks
    of both packages agree, and scaling the density factors moves the
    mask but not the render."""
    args = ["--arch.shading.model=MLP_Fea_WeakView_Density",
            "--+arch.shading.predict_density=true"]
    jt, pt = _pair(small_scene, args)
    _scale_density(jt, pt)
    res, step, thr = [12, 12, 12], 0.05, 1e-4
    jmask, jbox = jupdate_mask(jt.state.params.field, jt.vm_cfg, res, step,
                               thr)
    pmask, pbox = am.update_alpha_mask(pt.state.field, pt.vm_cfg, res, step,
                                       thr)
    np.testing.assert_array_equal(pmask.grid.numpy(), np.asarray(jmask.grid))
    np.testing.assert_allclose(pbox, np.asarray(jbox), atol=1e-6)
    rcfg = renderer.RenderConfig(n_samples=pt.n_samples,
                                 mlp_predict_density=True)
    c = torch.tensor([[0.0, 0.0, -4.0]] * 4)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.0, 1.0], [0.0, 0.1, 1.0],
                      [0.1, 0.1, 1.0]])
    before = renderer.render_rays(pt.state.field, pt.vm_cfg, rcfg, c, d,
                                  pt.near_far)
    with torch.no_grad():
        for p in pt.state.field.density_planes:
            p.mul_(0.01)
    after = renderer.render_rays(pt.state.field, pt.vm_cfg, rcfg, c, d,
                                 pt.near_far)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    moved, _ = am.update_alpha_mask(pt.state.field, pt.vm_cfg, res, step,
                                    thr)
    assert not torch.equal(moved.grid, pmask.grid)


def test_variant_trainers_run_every_phase(small_scene):
    """A CPU run of the trainer through an upsample, a mask build and the
    shrink with a variant, the density head and unstratified samples at
    once."""
    pt = Trainer(set_options(CFG, SMALL + [
        "--arch.convolve_plane_only=true",
        "--arch.shading.model=MLP_Fea_WeakView_Density",
        "--+arch.shading.predict_density=true",
        "--nerf.sample_stratified=false",
        "--train_schedule.update_alphamask_iters=[10]", "--max_iter=12"]),
        small_scene, device="cpu")
    res0 = pt.resolution
    hist = pt.run(log_every=1)
    assert len(hist) == 12 and all(np.isfinite(h["loss"]) for h in hist)
    assert pt.resolution != res0 and pt.alpha_mask is not None
    cfg = pt.last_step_config
    assert cfg.mlp_predict_density and not cfg.stratified
    assert dataclasses.replace(cfg).detach_viewdirs


ZOO_FIELDS = {**{k: v for k, v in VARIANTS.items()},
              "predict_density": dict(shading_mode="MLP_Fea_WeakView_Density"),
              "cp": dict(decomposition="CP"),
              "cp_component_wise": dict(decomposition="CP",
                                        component_wise_feature2density=True),
              "sh": dict(shading_mode="SH", app_dim=27)}


@pytest.mark.parametrize("densify_density,app_k,blur", [
    (True, 4, True), (False, 4, True), (False, None, True),
    (False, None, False)])
@pytest.mark.parametrize("name", list(ZOO_FIELDS))
def test_step_scatter_calls_match_expected_launches(monkeypatch, name,
                                                    densify_density, app_k,
                                                    blur):
    """One CPU step's row-scatter calls equal what chip_smoke's
    expected_launches asks of the card for that field and step."""
    _check_step_launches(monkeypatch, name, densify_density=densify_density,
                         app_k=app_k,
                         blur=BlurSpec("uniform-gaussian", 8) if blur
                         else None)


@pytest.mark.parametrize("name", list(ZOO_FIELDS))
def test_bf16_grid_step_scatter_calls_match_expected_launches(monkeypatch,
                                                              name):
    """With the dense grid allowed and its rows read in bfloat16 the
    renderer builds the grid (renderer.density_route): one blurred CPU
    step's row-scatter and K6 calls equal expected_launches for each
    field, and no field samples its density with K6 there (the grid, the
    head's density or convolve_positive_only's split)."""
    want = _check_step_launches(monkeypatch, name, densify_density=True,
                                densify_dtype="bfloat16", app_k=4,
                                blur=BlurSpec("uniform-gaussian", 8))
    assert want["density_sample_fwd"] == 0


def _check_step_launches(monkeypatch, name, **step_kw):
    """One CPU step of the ZOO_FIELDS field ``name`` under StepConfig
    ``step_kw``: its row-scatter, K6 and K7 calls against expected_launches,
    which it returns."""
    _, pcfg = _cfgs(**ZOO_FIELDS[name])
    predict = pcfg.shading_mode == "MLP_Fea_WeakView_Density"
    field = vm.init_vm(pcfg, (12, 12, 12), [-1.5] * 3 + [1.5] * 3,
                       torch.Generator().manual_seed(0))
    scene = synthetic.make_scene(n_views=2, H=12, W=12, device="cpu")
    scfg = StepConfig(H=12, W=12, n_views=2, rays_per_view=16, n_samples=48,
                      mlp_predict_density=predict, **step_kw)
    count = _Counter(monkeypatch)
    images = torch.as_tensor(scene.images).reshape(2, 3, -1).transpose(1, 2)
    metrics, _ = train_step(
        init_train_state(field, 2), scfg, pcfg, torch.as_tensor(scene.poses),
        torch.as_tensor(scene.intr_inv), images.contiguous(),
        torch.zeros((2, 144)), torch.arange(2), torch.arange(16),
        StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3,
                    c2f_density=0.1, c2f_color=0.1),
        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    want = chip_smoke.expected_launches(scfg, pcfg)
    assert count.n == want["scatter_add_rows"]
    assert count.k6 == count.k6_of(want)
    return want


def test_expected_launches_table():
    """K3, K6 and K7 a step by field and path in
    chip_smoke.expected_launches.  K3: the dense grid's row gather (1)
    where the grid is allowed and built (its rows read in bfloat16), each
    fused factor sample a plane and a line scatter a chunk (6 fused:
    convolve_plane_only, ignore_negative_split, the default field without
    app_k), convolve_positive_only's 3 density lines under the blur, CP's
    lines (3 appearance, 3 more without the grid); nothing else, since
    the VM appearance apart from the density is K7's.  Past
    _PROD_BWD_CHUNK samples (2**20) a fused sample scatters per chunk:
    BAT's 2028 x 1000 fused (2 chunks a sample, 12).  K6 (forward and
    backward alike) once a step exactly where the VM density is sampled
    from its factors apart from the appearance: app_k or the activation
    flags without the grid built, not CP, the density head or the split.
    K7 (forward and backward alike) once a step exactly where the VM
    appearance is sampled apart from the density: every route but the
    fused sample, the density head's included, never on CP; whatever its
    samples (LLFF's 4420 x 1000 and 20480 x 1000 on the dense appearance,
    pod16's app_k 128 on one rank and on each of two)."""
    blur = BlurSpec("uniform-gaussian", 8)

    def launches(field_kw, rays=1, **step_kw):
        _, pcfg = _cfgs(**field_kw)
        step_kw = {"n_views": 1, "rays_per_view": 8, "n_samples": 16,
                   "blur": blur, **step_kw}
        scfg = StepConfig(H=8, W=8, **step_kw)
        got = chip_smoke.expected_launches(scfg, pcfg, rays)
        assert got["density_sample_fwd"] == got["density_sample_bwd"]
        assert got["app_sample_fwd"] == got["app_sample_bwd"]
        return got

    def k3(*a, **kw):
        return launches(*a, **kw)["scatter_add_rows"]

    def k6(*a, **kw):
        return launches(*a, **kw)["density_sample_fwd"]

    def k7(*a, **kw):
        return launches(*a, **kw)["app_sample_fwd"]

    bf16 = dict(densify_density=True, densify_dtype="bfloat16")
    for name, kw in VARIANTS.items():
        positive = kw.get("convolve_positive_only", False)
        fusable = vm.can_fuse_features(_cfgs(**kw)[1])
        # the grid allowed: built for bf16 rows, K6 in float32 rows
        assert k3(kw, densify_density=True, app_k=64) == (
            3 if positive else 0), name
        assert k6(kw, densify_density=True, app_k=64) == (
            0 if positive else 1), name
        assert k3(kw, app_k=64, **bf16) == (3 if positive else 1), name
        assert k6(kw, app_k=64, **bf16) == 0, name
        assert k3(kw, app_k=64) == (3 if positive else 0), name
        assert k3(kw) == (3 if positive else 6 if fusable else 0), name
        assert k6(kw, app_k=64) == (0 if positive else 1), name
        assert k6(kw) == (0 if positive or fusable else 1), name
        for step_kw in (dict(densify_density=True, app_k=64),
                        dict(app_k=64, **bf16), dict(app_k=64)):
            assert k7(kw, **step_kw) == 1, name
        assert k7(kw) == (0 if fusable else 1), name
    assert k3(dict(convolve_plane_only=True)) == 6
    assert k3(dict(ignore_negative_split=True)) == 6
    assert k7(dict(ignore_negative_split=True)) == 0
    assert k3(dict(decomposition="CP"), densify_density=True, app_k=64) == 4
    assert k3(dict(decomposition="CP"), app_k=64) == 6
    assert k6(dict(decomposition="CP"), app_k=64) == 0
    assert k6(dict(decomposition="CP"), densify_density=True, app_k=64) == 0
    assert k7(dict(decomposition="CP"), app_k=64) == 0
    assert k7(dict(decomposition="CP")) == 0
    head = dict(shading_mode="MLP_Fea_WeakView_Density")
    assert k3(head, densify_density=True, app_k=64,
              mlp_predict_density=True) == 0
    assert k6(head, app_k=64, mlp_predict_density=True) == 0
    assert k7(head, mlp_predict_density=True) == 1
    # convolve_positive_only splits only under the blur
    assert k6(dict(convolve_positive_only=True), app_k=64, blur=None) == 1
    bat = dict(n_views=12, rays_per_view=169, n_samples=1000, blur=None)
    assert (k3({}, **bat), k6({}, **bat), k7({}, **bat)) == (12, 0, 0)
    assert k3({}, densify_density=True, app_k=128, **bat) == 0
    assert k3({}, app_k=128, **bf16, **bat) == 1
    assert k3({}, compact_k=512, app_k=128, **bat) == 0
    assert k3({}, compact_k=640, app_k=128, **bat) == 0
    assert k6({}, compact_k=640, app_k=128, **bat) == 1
    assert k7({}, compact_k=640, app_k=128, **bat) == 1
    assert k6({}, densify_density=True, app_k=128, **bat) == 1
    # LLFF's last phase and its first: the grid allowed, K6 taken (no K3
    # into the grid's 510.6M rows) and K7 for the dense appearance; 1 K3
    # with the grid's rows in bf16
    llff = dict(n_views=20, n_samples=1000, densify_density=True)
    for rays_per_view in (221, 1024):
        assert (k3({}, rays_per_view=rays_per_view, **llff),
                k6({}, rays_per_view=rays_per_view, **llff),
                k7({}, rays_per_view=rays_per_view, **llff)) == (0, 1, 1)
    assert k3({}, rays_per_view=221, densify_dtype="bfloat16", **llff) == 1
    pod16 = dict(n_views=16, rays_per_view=256, n_samples=1000,
                 compact_k=512, app_k=128, blur=None)
    assert k3({}, **pod16) == k3({}, rays=2, **pod16) == 0
    assert k6({}, **pod16) == k6({}, rays=2, **pod16) == 1
    assert k7({}, **pod16) == k7({}, rays=2, **pod16) == 1
    assert k3(dict(decomposition="CP"), **bat) == 6
    # the masked cell's step: 2500 rays x K 896, app_k 128
    masked = dict(n_views=100, rays_per_view=25, n_samples=1000,
                  compact_k=896, app_k=128, blur=None)
    assert (k3({}, **masked), k6({}, **masked), k7({}, **masked)) == (0, 1,
                                                                       1)


@pytest.mark.parametrize("densify_density,app_k", [(True, 4), (False, 4),
                                                   (False, None)])
def test_chunked_step_scatter_calls_match_expected_launches(
        monkeypatch, densify_density, app_k):
    """With _PROD_BWD_CHUNK at 200 samples a CPU step's 2 x 16 x 48 = 1536
    samples run 8 chunks in each fused backward: the row-scatter calls
    still equal expected_launches, which reads the constant.  With app_k
    no fused sample runs (the density is K6's, the appearance K7's, the
    dense grid allowed is not built in float32 rows): no row scatter."""
    monkeypatch.setattr(sampling, "_PROD_BWD_CHUNK", 200)
    _, pcfg = _cfgs()
    field = vm.init_vm(pcfg, (12, 12, 12), [-1.5] * 3 + [1.5] * 3,
                       torch.Generator().manual_seed(0))
    scene = synthetic.make_scene(n_views=2, H=12, W=12, device="cpu")
    scfg = StepConfig(H=12, W=12, n_views=2, rays_per_view=16, n_samples=48,
                      densify_density=densify_density, app_k=app_k)
    count = _Counter(monkeypatch)
    images = torch.as_tensor(scene.images).reshape(2, 3, -1).transpose(1, 2)
    metrics, _ = train_step(
        init_train_state(field, 2), scfg, pcfg, torch.as_tensor(scene.poses),
        torch.as_tensor(scene.intr_inv), images.contiguous(),
        torch.zeros((2, 144)), torch.arange(2), torch.arange(16),
        StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3),
        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    want = chip_smoke.expected_launches(scfg, pcfg)
    assert count.n == want["scatter_add_rows"] == (0 if app_k else 6 * 8)
    assert count.k6 == count.k6_of(want)


EVAL_ZOO = {
    "predict_density": ["--arch.shading.model=MLP_Fea_WeakView_Density",
                        "--+arch.shading.predict_density=true"],
    "cp": ["--arch.tensorf.model=BAT_CP"],
    "sh": ["--arch.shading.model=SH", "--arch.shading.app_dim=27"],
    "mlp_pe": ["--arch.shading.model=MLP_PE"]}


def _window_density(jt):
    """The JAX field's density factors x 6 over the box of fractions
    [0.3, 0.7] of every axis, zero outside: no density near the box's
    faces, where an unstratified ray's first sample sits and one rounding
    puts it in or out of the box."""
    f = jt.state.params.field
    res = f.resolution()
    win = [np.where(np.abs(np.arange(r) / (r - 1) - 0.5) <= 0.2, 6.0,
                    0.0).astype(np.float32) for r in res]
    f.density_planes = [
        p * win[jvm.MAT_MODE[i][1]][:, None, None]
        * win[jvm.MAT_MODE[i][0]][None, :, None]
        for i, p in enumerate(f.density_planes)]
    f.density_lines = [l * win[jvm.VEC_MODE[i]][:, None]
                       for i, l in enumerate(f.density_lines)]


@pytest.mark.parametrize("name", list(EVAL_ZOO))
def test_eval_and_test_time_renders_match_jax(small_scene, name):
    """render_views (with the mask built from the density factors and the
    eval budget) and 3 test-time steps with JAX's draws.  The renders
    within 1e-4: the default head on the same field and views parts from
    JAX by 2.2e-5 (view directions one rounding apart).  JAX's evaluate.py
    test-time config leaves mlp_predict_density off, and its renderer then
    fails on the density head's pair: the JAX side gets the flag here, as
    the port's render_config sets it."""
    from joint_tensorf_tpu.pose.test_optim import \
        make_test_time_optimizer as jmake_optimizer
    from joint_tensorf_tpu.render.renderer import RenderConfig as JRC
    from joint_tensorf_tpu_torch.pose.test_optim import (
        make_test_time_optimizer, render_config)
    from test_torch_eval import carry_to_port
    from test_torch_test_optim import jax_draws

    jt, pt = _pair(small_scene, EVAL_ZOO[name])
    _window_density(jt)
    jt._update_alphamask(8)
    carry_to_port(jt, pt)
    assert 0 < float(pt.alpha_mask.grid.mean()) < 1
    poses = small_scene.poses[:2]
    rgb_j = np.asarray(jt.render_views(
        jnp.asarray(poses), jnp.asarray(small_scene.intr[:2]),
        jnp.asarray(small_scene.intr_inv[:2]))[0])
    rgb_p = pt.render_views(torch.as_tensor(poses), small_scene.intr[:2],
                            torch.as_tensor(small_scene.intr_inv[:2]))[0]
    np.testing.assert_allclose(rgb_p.numpy(), rgb_j, atol=1e-4)
    assert pt.last_eval_config.mlp_predict_density == (
        name == "predict_density")
    H = W = 16
    predict = name == "predict_density"
    jrc = JRC(n_samples=jt.n_samples, is_train=True, use_alpha_mask=True,
              stop_coord_grad=False, mlp_predict_density=predict)
    j_opt = jmake_optimizer(jt.vm_cfg, jrc, jt.head, H, W, n_rays=32,
                            test_iter=3, lr_init=1e-3, lr_end=1e-4)
    p_opt = make_test_time_optimizer(pt.vm_cfg, render_config(pt), H, W,
                                     n_rays=32, test_iter=3, lr_init=1e-3,
                                     lr_end=1e-4)
    image = small_scene.images[2].reshape(3, -1).T
    key = jax.random.PRNGKey(3)
    args_j = (jt.state.params.field, jt.alpha_mask,
              jnp.asarray(small_scene.poses[2]), jnp.asarray(image),
              jnp.asarray(small_scene.intr[2]),
              jnp.asarray(small_scene.intr_inv[2]),
              jnp.asarray(pt._near_far(), jnp.float32), key)
    j_pose, j_loss = j_opt(*args_j)
    draws = jax_draws(key, H, W, 32, 3)
    p_pose, p_loss = p_opt(pt.state.field, pt.alpha_mask,
                           torch.as_tensor(small_scene.poses[2]),
                           torch.as_tensor(image),
                           torch.as_tensor(small_scene.intr_inv[2]),
                           pt._near_far(), draws=lambda it: draws[it])
    np.testing.assert_allclose(p_pose.numpy(), np.asarray(j_pose),
                               atol=1e-5)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
    if predict:
        # evaluate.py's config, as JAX builds it, fails on the head's pair
        bad = jmake_optimizer(jt.vm_cfg, dataclasses.replace(
            jrc, mlp_predict_density=False), jt.head, H, W, n_rays=32,
            test_iter=1, lr_init=1e-3, lr_end=1e-4)
        with pytest.raises(AttributeError):
            bad(*args_j)


def test_pose_gradient_maps_on_cp_and_the_density_head(small_scene):
    """Trainer.visualize_pose_gradient: on a CP field the maps equal JAX's
    within 1e-4 of each map's max; with the density head JAX's renderer
    fails (its render config there leaves mlp_predict_density off), and
    the port renders with the head's density: finite, non-zero maps."""
    jt, pt = _pair(small_scene, EVAL_ZOO["cp"])
    _window_density(jt)
    from test_torch_eval import carry_to_port
    carry_to_port(jt, pt)
    want = jt.visualize_pose_gradient(view=1, n_rays_chunk=128)
    got = pt.visualize_pose_gradient(view=1, n_rays_chunk=128)
    for g, w, name in zip(got, want, ("rot", "trans")):
        w = np.asarray(w)
        assert g.shape == w.shape == (3, 16, 16) and np.abs(w).max() > 0
        for c in range(3):
            np.testing.assert_allclose(g[c], w[c],
                                       atol=1e-4 * np.abs(w[c]).max(),
                                       err_msg=f"{name}[{c}]")
    jt, pt = _pair(small_scene, EVAL_ZOO["predict_density"])
    with pytest.raises(AttributeError):
        jt.visualize_pose_gradient(view=1, n_rays_chunk=128)
    got = pt.visualize_pose_gradient(view=1, n_rays_chunk=128)
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in got)
