"""PyTorch port vs JAX: test-time pose optimisation, and the backward pass
with a frozen field.

* make_test_time_optimizer on a JAX trainer state carried into the port
  (a box of density and its alpha mask), fed JAX's own draws (the key
  chain of evaluate.py: PRNGKey(seed + 7) split per view, split per
  iteration, the permutation of fold_in(k, 0) and the renderer's jitter):
  5 iterations, the refined pose within 1e-5 of JAX's and moved off the
  input pose, the final loss at rtol 1e-4;
* a frozen field (factors and head requires_grad False, the pose
  requires_grad): the pose gradient equals the unfrozen backward's bit for
  bit, on the fused dense-appearance path (test-time optimisation's), the
  two-stage appearance and the dense grid, and the row scatter
  (sampling.scatter_add_rows, densify.scatter_add_rows; K3 on CUDA) is
  called zero times, nor the factor scatters of the summed density
  sample and the concatenated appearance sample (K6's and K7's plain
  versions; unfrozen 12 on the two-stage path, 6 beside the dense grid);
* the training step still calls the row scatter as often as
  chip_smoke.expected_launches says: none with the two-stage appearance
  (the density's factor sample is K6 and the appearance's K7, each once
  forward and once backward), also where the dense grid is allowed in
  float32 rows (renderer.density_route builds it only where K6 does not
  apply or its rows are bfloat16), 6 on the fused path (a plane and a
  line scatter for each axis).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import (_box_field, _jscene, carry_to_port,  # noqa: F401
                             one_torch_thread)

import chip_smoke
from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.pose.test_optim import \
    make_test_time_optimizer as jmake_optimizer
from joint_tensorf_tpu.render.renderer import RenderConfig as JRenderConfig
from joint_tensorf_tpu.train.trainer import Trainer as JTrainer
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.data import synthetic
from joint_tensorf_tpu_torch.geometry import lie, poses as pose_ops
from joint_tensorf_tpu_torch.geometry.rays import get_center_and_ray
from joint_tensorf_tpu_torch.models import vm
from joint_tensorf_tpu_torch.ops import densify, sampling
from joint_tensorf_tpu_torch.pose.test_optim import (frozen,
                                                     make_test_time_optimizer,
                                                     render_config)
from joint_tensorf_tpu_torch.render.renderer import (RenderConfig,
                                                     density_route,
                                                     render_rays)
from joint_tensorf_tpu_torch.train.step import StepConfig, StepScalars, \
    init_train_state, train_step
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()

CFG = "configs/bat_blender_VM.yaml"
SMALL = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
         "--data.n_views=4", "--data.val_sub=2",
         "--train_schedule.n_voxel_init=64000",
         "--train_schedule.n_voxel_final=262144",
         "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
         "--blur_2d_c2f_kernel_size=15", "--max_iter=20",
         "--arch.tensorf.density_components=[3,3,3]",
         "--arch.tensorf.color_components=[4,4,4]",
         "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=8",
         "--train_schedule.upsample_iters=[10]",
         "--train_schedule.update_alphamask_iters=[12]",
         "--train_schedule.shrink_bbox_with_alphamask=false"]


def jax_draws(key, H, W, n_rays, n_iter):
    """One view's draws as JAX's test-time step makes them from its key."""
    out = []
    for _ in range(n_iter):
        key, k = jax.random.split(key)
        idx = jax.random.permutation(jax.random.fold_in(k, 0), H * W)[:n_rays]
        jitter = jax.random.uniform(jax.random.split(k)[0], (n_rays, 1))
        out.append((torch.as_tensor(np.asarray(idx), dtype=torch.long),
                    torch.as_tensor(np.asarray(jitter))))
    return out


def test_test_time_optimizer_matches_jax():
    sc = synthetic.make_scene(n_views=4, H=16, W=16, device="cpu")
    test = synthetic.make_scene(n_views=2, H=16, W=16, pose_seed=1000,
                                device="cpu")
    jt = JTrainer(jset_options(CFG, SMALL), _jscene(sc))
    jt.state = dataclasses.replace(jt.state, params=dataclasses.replace(
        jt.state.params, field=_box_field(jt.state.params.field,
                                          np.random.default_rng(0))))
    jt._update_alphamask(12)
    pt = Trainer(set_options(CFG, SMALL), sc, device="cpu")
    carry_to_port(jt, pt)
    H = W = 16
    n_rays, n_iter = pt._n_rays(), 5
    assert n_rays == jt._n_rays() == 64
    lr0, lr1 = 1e-3, 1e-4
    j_opt = jmake_optimizer(
        jt.vm_cfg, JRenderConfig(n_samples=jt.n_samples, is_train=True,
                                 use_alpha_mask=True, stop_coord_grad=False),
        jt.head, H, W, n_rays=n_rays, test_iter=n_iter, lr_init=lr0,
        lr_end=lr1)
    p_opt = make_test_time_optimizer(pt.vm_cfg, render_config(pt), H, W,
                                     n_rays=n_rays, test_iter=n_iter,
                                     lr_init=lr0, lr_end=lr1)
    images = test.images.reshape(2, 3, -1).transpose(0, 2, 1)
    near_far = pt._near_far()
    key = jax.random.PRNGKey(7)
    for i in range(2):
        key, k = jax.random.split(key)
        j_pose, j_loss = j_opt(jt.state.params.field, jt.alpha_mask,
                               jnp.asarray(test.poses[i]),
                               jnp.asarray(images[i]),
                               jnp.asarray(test.intr[i]),
                               jnp.asarray(test.intr_inv[i]),
                               jnp.asarray(near_far, jnp.float32), k)
        draws = jax_draws(k, H, W, n_rays, n_iter)
        p_pose, p_loss = p_opt(pt.state.field, pt.alpha_mask,
                               torch.as_tensor(test.poses[i]),
                               torch.as_tensor(images[i]),
                               torch.as_tensor(test.intr_inv[i]), near_far,
                               draws=lambda it: draws[it])
        np.testing.assert_allclose(p_pose.numpy(), np.asarray(j_pose),
                                   atol=1e-5)
        assert float(np.abs(p_pose.numpy() - test.poses[i]).max()) > 1e-4
        np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
    # the field was frozen only while the optimiser ran
    assert all(p.requires_grad for p in pt.state.field.parameters())


def _small_field():
    cfg = vm.VMConfig(density_n_comp=(3, 3, 3), app_n_comp=(4, 4, 4),
                      app_dim=6, hidden=8)
    gen = torch.Generator().manual_seed(0)
    field = vm.init_vm(cfg, (20, 20, 20), [-1.5] * 3 + [1.5] * 3, gen)
    with torch.no_grad():
        for p in list(field.density_planes) + list(field.density_lines):
            p.mul_(8.0)
    return cfg, field


class _Counter:
    """A CPU step's calls where the card launches a kernel: ``n`` the row
    scatters (K3), ``k6`` the summed density sample's and the concatenated
    appearance sample's plain versions forward and backward (K6's and K7's
    two entry points each), ``rows`` the index_add_ row scatters of the
    plain samplers (K6's and K7's plain factor gradients)."""

    # each plain version by the entry points of its kernel
    PLAIN = {"sample_planeline_prod_sum_plain": "density_sample",
             "sample_planeline_prod_cat_plain": "app_sample"}

    def __init__(self, monkeypatch):
        self.n = self.rows = 0
        self.k6 = {f"{k}_{d}": 0 for k in self.PLAIN.values()
                   for d in ("fwd", "bwd")}
        for mod in (sampling, densify):
            real = mod.scatter_add_rows

            def counted(*a, real=real):
                self.n += 1
                return real(*a)
            monkeypatch.setattr(mod, "scatter_add_rows", counted)
        for name, kernel in self.PLAIN.items():
            monkeypatch.setattr(sampling, name,
                                self._counted(getattr(sampling, name), kernel))
        real_rows = sampling._index_add_rows

        def rows(*a):
            self.rows += 1
            return real_rows(*a)
        monkeypatch.setattr(sampling, "_index_add_rows", rows)

    def _counted(self, real, kernel):
        """``real``, counting its calls as ``kernel``'s forward and the
        backwards through its output as ``kernel``'s backward."""
        def bwd(g):
            self.k6[f"{kernel}_bwd"] += 1

        def plain(*a, **kw):
            self.k6[f"{kernel}_fwd"] += 1
            out = real(*a, **kw)
            if out.requires_grad:
                out.register_hook(bwd)
            return out
        return plain

    def k6_of(self, launches):
        """The K6 and K7 entries of an expected_launches dict."""
        return {k: launches[k] for k in self.k6}


@pytest.mark.parametrize("path", ["fused", "app_k", "dense_grid"])
def test_frozen_field_backward_skips_factor_scatter(monkeypatch, path):
    # the renderer builds the VM field's dense grid for bf16 rows alone
    # (renderer.density_route)
    cfg, field = _small_field()
    rcfg = RenderConfig(n_samples=48, is_train=True,
                        densify_density=path == "dense_grid",
                        densify_dtype=("bfloat16" if path == "dense_grid"
                                       else "float32"),
                        app_k=None if path == "fused" else 16)
    assert (density_route(rcfg, cfg, False) == "grid") == (
        path == "dense_grid")
    scene = synthetic.make_scene(n_views=1, H=12, W=12, device="cpu")
    pose = torch.as_tensor(scene.poses)
    intr_inv = torch.as_tensor(scene.intr_inv)
    jitter = torch.rand((144, 1), generator=torch.Generator().manual_seed(1))

    def pose_grad():
        se3 = torch.full((1, 6), 0.01, requires_grad=True)
        c, d = get_center_and_ray(12, 12, pose_ops.compose(
            [lie.se3_to_SE3(se3), pose]), intr_inv)
        rgb, _, _ = render_rays(field, cfg, rcfg, c.reshape(-1, 3),
                                d.reshape(-1, 3), (2.0, 6.0),
                                ray_jitter=jitter)
        return torch.autograd.grad(torch.sum(rgb ** 2), [se3])[0]

    count = _Counter(monkeypatch)
    g_full = pose_grad()
    n_full, rows_full = count.n, count.rows
    count.n = count.rows = 0
    with frozen(field):
        g_frozen = pose_grad()
    assert count.n == 0 and count.rows == 0
    # unfrozen: the fused sample's K3 scatters (6), or the appearance's
    # sample (K7 on the card, 6 plain row scatters) beside the dense grid,
    # or the density's factor sample (K6) and K7 (6 each); frozen, none
    assert (n_full, rows_full) == {"fused": (6, 0), "app_k": (0, 12),
                                   "dense_grid": (0, 6)}[path]
    assert torch.equal(g_frozen, g_full)
    assert torch.count_nonzero(g_full) > 0


@pytest.mark.parametrize("densify_density,app_k", [(True, 4), (False, 4),
                                                   (False, None)])
def test_train_step_scatter_calls_unchanged(monkeypatch, densify_density,
                                            app_k):
    cfg, field = _small_field()
    scene = synthetic.make_scene(n_views=2, H=12, W=12, device="cpu")
    scfg = StepConfig(H=12, W=12, n_views=2, rays_per_view=16, n_samples=48,
                      densify_density=densify_density, app_k=app_k)
    count = _Counter(monkeypatch)
    images = torch.as_tensor(scene.images).reshape(2, 3, -1).transpose(1, 2)
    metrics, _ = train_step(
        init_train_state(field, 2), scfg, cfg, torch.as_tensor(scene.poses),
        torch.as_tensor(scene.intr_inv), images.contiguous(),
        torch.zeros((2, 144)), torch.arange(2), torch.arange(16),
        StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3),
        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    want = chip_smoke.expected_launches(scfg, cfg)
    k6 = int(app_k is not None)
    assert count.n == want["scatter_add_rows"] == 6 * (1 - k6)
    assert count.k6 == count.k6_of(want) == {
        "density_sample_fwd": k6, "density_sample_bwd": k6,
        "app_sample_fwd": k6, "app_sample_bwd": k6}
