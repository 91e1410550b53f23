"""PyTorch port vs JAX: render_rays on the dense Euclidean path.

* The golden state of tests/test_golden_render.py, converted from JAX,
  reproduces GOLDEN_SHARP and GOLDEN_BLUR at that test's tolerance
  (rtol 2e-4 / atol 2e-5).
* In train mode with handed-in stratified jitter, blur on, the outputs
  match JAX (atol 1e-5) and so do the gradients w.r.t. every field leaf
  and w.r.t. the ray centers and directions (the pose path): rtol 1e-4 and
  atol 1e-4 of each gradient's largest entry, since the factor scatters
  and the compositor's sums run in another order.
* The live mask that render_rays hands the summed density sample (K6 on
  the card) changes nothing on the CPU: on a plain field and a blurred
  one, compacted with the two-stage appearance, the outputs and every
  gradient (field leaves, ray centers and directions) equal those of the
  same render with the mask dropped bit for bit, and ``sampled_frac``
  equals ``valid_frac``; so do an L2G trainer's state and metrics after
  its first iterations (upsample and alpha mask included) on that path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_golden_render import GOLDEN_BLUR, GOLDEN_SHARP, _setup
from torch_parity import field_leaves, flatten_field

from joint_tensorf_tpu.render import renderer as jrenderer
from joint_tensorf_tpu_torch.convert import field_from_numpy
from joint_tensorf_tpu_torch.models import vm as vm_lib
from joint_tensorf_tpu_torch.models.vm import VMConfig
from joint_tensorf_tpu_torch.render.renderer import (BlurSpec, RenderConfig,
                                                     render_rays)
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

PORT_CFG = VMConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4),
                    app_dim=9, hidden=16)


def _golden_check(out, golden):
    for got, key in zip(out, ("rgb", "depth", "opacity")):
        np.testing.assert_allclose(got.detach().numpy().reshape(-1),
                                   golden[key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)


def test_golden_values():
    _, _, state, _, centers, dirs = _setup()
    field = field_from_numpy(flatten_field(state), PORT_CFG)
    rcfg = RenderConfig(n_samples=24, is_train=False)
    c, d = torch.as_tensor(np.asarray(centers)), torch.as_tensor(
        np.asarray(dirs))
    _golden_check(render_rays(field, PORT_CFG, rcfg, c, d, (2.0, 6.0)),
                  GOLDEN_SHARP)
    _golden_check(render_rays(field, PORT_CFG, rcfg, c, d, (2.0, 6.0),
                              blur=BlurSpec("uniform-gaussian", 8),
                              c2f_density=0.2, c2f_color=0.2),
                  GOLDEN_BLUR)


def test_train_mode_outputs_and_gradients():
    cfg, head, state, _, _, _ = _setup()
    rng = np.random.default_rng(0)
    n = 48
    centers = (np.array([0.0, 0.0, -4.0]) + rng.normal(0, 0.05, (n, 3))
               ).astype(np.float32)
    xy = rng.uniform(-0.3, 0.3, (n, 2))
    dirs = np.concatenate([xy, np.ones((n, 1))], -1).astype(np.float32)
    dirs[0, 0] = 0.0                       # the where(dirs==0, 1e-6) guard
    g_rgb = rng.standard_normal((n, 3)).astype(np.float32)
    g_acc = rng.standard_normal(n).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jitter = np.asarray(jax.random.uniform(jax.random.split(key)[0], (n, 1)))
    blur = dict(c2f_density=0.15, c2f_color=0.25)

    jr = jrenderer.RenderConfig(n_samples=24, is_train=True, white_bg=True)

    def jloss(st, c, d):
        rgb, _, acc = jrenderer.render_rays(
            st, cfg, jr, head, c, d, key, jnp.array([2.0, 6.0]),
            blur=jrenderer.BlurSpec("uniform-gaussian", 8),
            c2f_density=jnp.float32(blur["c2f_density"]),
            c2f_color=jnp.float32(blur["c2f_color"]))
        return jnp.sum(rgb * g_rgb) + jnp.sum(acc * g_acc), (rgb, acc)

    (_, (j_rgb, j_acc)), (g_st, g_c, g_d) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            state, jnp.asarray(centers), jnp.asarray(dirs))

    field = field_from_numpy(flatten_field(state), PORT_CFG)
    tc = torch.as_tensor(centers).requires_grad_(True)
    td = torch.as_tensor(dirs).requires_grad_(True)
    rgb, _, acc = render_rays(
        field, PORT_CFG, RenderConfig(n_samples=24, is_train=True), tc, td,
        (2.0, 6.0), blur=BlurSpec("uniform-gaussian", 8),
        ray_jitter=torch.as_tensor(jitter), **blur)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb),
                               atol=1e-5)
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(j_acc),
                               atol=1e-5)
    (torch.sum(rgb * torch.as_tensor(g_rgb))
     + torch.sum(acc * torch.as_tensor(g_acc))).backward()

    want = field_leaves(flatten_field(g_st))
    want["centers"], want["dirs"] = np.asarray(g_c), np.asarray(g_d)
    got = {k: p.grad.numpy() for k, p in field.named_parameters()}
    got["centers"], got["dirs"] = tc.grad.numpy(), td.grad.numpy()
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)
    assert np.abs(want["dirs"]).max() > 0      # the pose path is live


def _unmasked(monkeypatch):
    """compute_density_feature with the live mask dropped: every slot
    evaluated, as before the mask was handed in."""
    real = vm_lib.compute_density_feature

    def every_slot(*a, live=None, **kw):
        return real(*a, **kw)
    monkeypatch.setattr(vm_lib, "compute_density_feature", every_slot)


@pytest.mark.parametrize("kind", ["plain", "blurred"])
def test_live_mask_changes_nothing_on_the_cpu(monkeypatch, kind):
    cfg = VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                   app_dim=6, hidden=8)
    field = vm_lib.init_vm(cfg, (20, 20, 20), [-1.5] * 3 + [1.5] * 3,
                           torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in list(field.density_planes) + list(field.density_lines):
            p.mul_(8.0)
    rng = np.random.default_rng(1)
    n = 40
    centers = (np.array([0.0, 0.0, -4.0]) + rng.normal(0, 0.05, (n, 3))
               ).astype(np.float32)
    dirs = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), np.ones((n, 1))],
                          -1).astype(np.float32)
    rcfg = RenderConfig(n_samples=64, is_train=True, compact_k=48, app_k=16)
    blur = (dict(blur=BlurSpec("uniform-gaussian", 8), c2f_density=0.1,
                 c2f_color=0.2) if kind == "blurred" else {})
    jitter = torch.as_tensor(rng.random((n, 1)).astype(np.float32))
    cot = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32))

    def render():
        c = torch.as_tensor(centers).requires_grad_(True)
        d = torch.as_tensor(dirs).requires_grad_(True)
        stats = {}
        out = render_rays(field, cfg, rcfg, c, d, (2.0, 6.0),
                          ray_jitter=jitter, stats=stats, **blur)
        leaves = [c, d] + list(field.parameters())
        grads = torch.autograd.grad(
            (out[0] * cot).sum() + out[1].sum() + out[2].sum(), leaves,
            allow_unused=True)
        return out, grads, stats

    out, grads, stats = render()
    assert float(stats["sampled_frac"]) == float(stats["valid_frac"])
    assert 0 < float(stats["valid_frac"]) < float(stats["kept_frac"])
    with monkeypatch.context() as m:
        _unmasked(m)
        out0, grads0, _ = render()
    for a, b in zip(out, out0):
        assert torch.equal(a, b)
    for a, b in zip(grads, grads0):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    assert torch.count_nonzero(grads[1]) > 0       # the pose path is live


def test_live_mask_changes_nothing_in_an_l2g_trainer(monkeypatch):
    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.train import l2g
    from joint_tensorf_tpu_torch.train.l2g_trainer import L2GTrainer

    opt = set_options("configs/l2g_bat_blender_VM.yaml", [
        "--data.dataset=synthetic", "--data.image_size=[16,16]",
        "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
        "--train_schedule.n_voxel_final=13824",
        "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
        "--blur_2d_c2f_kernel_size=15", "--max_iter=4",
        "--arch.tensorf.density_components=[3,3,3]",
        "--arch.tensorf.color_components=[4,4,4]",
        "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
        "--arch.embedding_dim=4", "--arch.layers_warp=[8,8,6]",
        "--arch.skip_warp=[1]", "--error_map_size=8",
        "--train_schedule.upsample_iters=[1]",
        "--train_schedule.update_alphamask_iters=[2]",
        "--tpu.densify_density=false"])
    data = load_dataset(opt, "train", device="cpu")

    def run():
        tr = L2GTrainer(opt, data, device="cpu")
        hist = []
        tr.run(max_iter=4, log_every=1, stats=True,
               callback=lambda t, m: hist.append(m))
        return tr, hist

    tr, hist = run()
    with monkeypatch.context() as m:
        _unmasked(m)
        tr0, hist0 = run()
    assert tr.last_step_config.app_k is not None
    assert not tr.last_step_config.densify_density
    assert all(h["sampled_frac"] == h["valid_frac"] for h in hist)
    assert all(h["valid_frac"] < h["kept_frac"] for h in hist)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist0]
    a, b = tr.state.field.state_dict(), tr0.state.field.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    a, b = l2g.pose_params(tr.state), l2g.pose_params(tr0.state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(tr.state.optimised_poses, tr0.state.optimised_poses)
    assert torch.equal(tr.state.error_map, tr0.state.error_map)
