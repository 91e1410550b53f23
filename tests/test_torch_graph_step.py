"""BAT's step as the CUDA graph captures it (train/graph_step.py,
step.unsharded_step) against train_step.

On the CPU (no graph is captured there):

* the captured function, run eagerly on static buffers (the rays, the
  predrawn jitter and background coin, the vector of per-iteration values
  with its Adams' bias corrections as graph_step lays it out, the counts
  advanced on the host), gives train_step's losses, render fractions,
  parameters, both Adams' moments and counts, pose table, pose-gradient
  accumulator and generator state bit for bit over 3 steps, and so does
  train_step with the field's Adam as optim.adam_update (the bf16 leaves'
  route): a tiny masked BAT step (compaction, app_k, the alpha mask, the
  grid's depth TV) and a tiny NDC step (random background, a moving near
  plane, TV weights that decay, the pose update on an 8-step cadence, so
  both of its branches);
* optim.masked_adam_update_ against adam_update then masked_update, bit
  for bit, with do_step set and not, as a host bool and as a tensor;
* graph_step.engages: only on a card, without a mesh or the blur, on a
  train state of float32 leaves; the CPU Trainer counts every step eager;
* the 2D blur cache refreshes into its own tensors, with the values of a
  fresh build, so a refresh leaves a captured step's addresses alone.

On the card (``-m cuda``; this file imports no JAX, so it runs there as
``python -m pytest --noconftest -q tests/test_torch_graph_step.py``): the
graphed trainer against the eager one over 5 steps on both routes (within
the spread of two eager runs: K6's and K7's backward add with atomics),
new captures after an upsample and an alpha-mask update, the eager path
under the blur, a mesh and on the CPU, a key that changes every step run
as train_step, cuda_build.LAUNCHES per replayed step equal to an eager
step's and to the hand-written kernels a profiled replay runs,
graph_counts, and no sync inside a replayed step's spans.
"""
import types

import numpy as np
import pytest
import torch

import chip_smoke
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.data import load_dataset
from joint_tensorf_tpu_torch.ops import cuda_build
from joint_tensorf_tpu_torch.render.renderer import BlurSpec
from joint_tensorf_tpu_torch.train import graph_step
from joint_tensorf_tpu_torch.train.optim import (adam_init, adam_scales,
                                                 adam_update,
                                                 masked_adam_update_,
                                                 masked_update)
from joint_tensorf_tpu_torch.train import step as step_lib
from joint_tensorf_tpu_torch.train.step import StepConfig
from joint_tensorf_tpu_torch.train.trainer import Trainer
from joint_tensorf_tpu_torch.utils import setup_torch, tracing

setup_torch()

TINY = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
        "--data.n_views=4", "--train_schedule.n_voxel_init=4096",
        "--train_schedule.n_voxel_final=110592", "--max_iter=14",
        "--train_schedule.upsample_iters=[2,4]",
        "--train_schedule.update_alphamask_iters=[6,10]",
        "--arch.tensorf.density_components=[6,6,6]",
        "--arch.tensorf.color_components=[8,8,8]",
        "--arch.shading.app_dim=6", "--arch.shading.mlp_hidden_dim=16",
        "--tpu.densify_min_samples_per_chip=1000",
        "--train_schedule.n_rays_init=64", "--train_schedule.n_rays_rest=64",
        "--c2f_kernel_size=8", "--blur_2d_c2f_kernel_size=15"]
# route -> (configuration, its arguments, the first compared iteration):
# masked, iterations 7-9 compact to 128 of 98 x 2 slots behind the mask
# with app_k 64 and the grid's depth TV at 0.5; NDC, iterations 7-9 with
# the near plane moving, the TV terms on and the pose stepping at 8 only
ROUTES = {
    "masked": ("bat_blender_VM", ["--+loss_weight.TV_depth=0.5"], 7),
    "ndc": ("bat_llff_VM_MLP", [
        "--data.scene=facing", "--loss_weight.TV_density=1.0",
        "--loss_weight.TV_color=1.0",
        "--tensorf_near_plane_schedule=[0.4,0.2,0.0]"], 7),
}


def _trainer(route: str, device="cpu", extra=()):
    yaml, args, _ = ROUTES[route]
    opt = set_options(f"configs/{yaml}.yaml", TINY + args + list(extra))
    tr = Trainer(opt, load_dataset(opt, "train", device="cpu"),
                 device=device)
    chip_smoke.warm_start_density(tr, int(opt.data.get("seed", 0)))
    return tr


def _iterate(tr, n: int) -> list:
    """``n`` iterations as Trainer.run makes them -> each step's metrics,
    the render fractions among them, as floats."""
    out = []
    for _ in range(n):
        m = tr.train_iteration(stats=True)
        out.append({k: float(v) for k, v in m.items()})
        tr._update_schedule()
        tr.it += 1
    return out


def _state(tr) -> dict:
    st = tr.state
    out = {f"field.{k}": v.detach().cpu().clone()
           for k, v in st.field.state_dict().items()}
    for name in ("scene_opt", "pose_opt"):
        opt = getattr(st, name)
        for m in ("mu", "nu"):
            out.update({f"{name}.{m}.{k}": t.cpu().clone()
                        for k, t in getattr(opt, m).items()})
        out[f"{name}.count"] = opt.count
    out["se3_refine"] = st.se3_refine.detach().cpu().clone()
    out["pose_grad_accum"] = st.pose_grad_accum.cpu().clone()
    out["generator"] = tr.generator.get_state().clone()
    return out


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _captured_on_static_buffers(tr):
    """Trainer._step as graph_step runs a key's step, without the graph:
    step.unsharded_step on copies of the rays and draws, its moving values
    the entries of one float32 vector (graph_step.host_values,
    device_scalars), the counts advanced on the host."""
    def step(cfg, view_sel, ray_idx, s, generator=None, jitter=None,
             bg_coin=None, alpha_mask=None, stats=False, mesh=None):
        n = view_sel.shape[0] * ray_idx.shape[0]
        jitter, bg_coin = step_lib.predraw(cfg, n, generator, tr.device,
                                           jitter, bg_coin)
        values = torch.from_numpy(graph_step.host_values(
            tr.state, cfg, s, tr.device))
        scalars, scales = graph_step.device_scalars(values, s)
        out, _ = step_lib.unsharded_step(
            tr.state, cfg, tr.vm_cfg, tr.pose_base, tr.intr_inv,
            tr.current_images, tr.current_edges, view_sel.clone(),
            ray_idx.clone(), scalars, scales,
            jitter=None if jitter is None else jitter.clone(),
            alpha_mask=alpha_mask, intr=tr.intr,
            bg_coin=None if bg_coin is None else bg_coin.clone())
        step_lib.advance_counts(tr.state, cfg, s)
        metrics = {k: v.clone() for k, v in out.items()}
        if stats:
            metrics["blur"] = 0.0
        return metrics, None
    return step


@pytest.mark.parametrize("route", list(ROUTES))
def test_captured_step_is_train_step_bit_for_bit(route, monkeypatch):
    start = ROUTES[route][2]
    runs = []
    for how in ("train_step", "captured", "adam_update"):
        tr = _trainer(route)
        tr.run(max_iter=start, log_every=100)
        if how == "captured":
            monkeypatch.setattr(tr, "_step", _captured_on_static_buffers(tr))
        elif how == "adam_update":
            monkeypatch.setattr(step_lib, "float32_leaves", lambda f: False)
        metrics = _iterate(tr, 3)
        monkeypatch.undo()
        cfg = tr.last_step_config
        assert cfg.blur is None and tr.alpha_mask is not None
        if route == "masked":
            assert cfg.compact_k is not None and cfg.app_k is not None
            assert cfg.grid_hw is not None and tr._tv_depth_weight() > 0
        else:
            assert cfg.ndc and not cfg.white_bg
        assert tr.graph_counts == {
            "captures": 0, "replays": 0,
            "eager": start + (0 if how == "captured" else 3)}
        runs.append((metrics, _state(tr)))
    m0, s0 = runs[0]
    for m1, s1 in runs[1:]:
        assert m0 == m1
        assert s0.keys() == s1.keys()
        for k in s0:
            assert _same(s0[k], s1[k]), k
    assert "kept_frac" in m0[0] and "valid_frac" in m0[0]
    if route == "ndc":
        # the pose stepped at iteration 8 alone of 7-9
        assert s0["pose_opt.count"] == 2


@pytest.mark.parametrize("on_device", [True, False])
@pytest.mark.parametrize("do_step", [True, False])
def test_masked_adam_update_is_adam_update_then_masked_update(do_step,
                                                              on_device):
    gen = torch.Generator().manual_seed(5)
    param = {"se3_refine": torch.randn((6, 6), generator=gen)}
    mine = {k: v.clone() for k, v in param.items()}
    state, state_ = adam_init(param), adam_init(mine)
    for it in range(3):
        # gradients from 1e-9 (about Adam's eps) to 1
        g = {"se3_refine": torch.randn((6, 6), generator=gen)
             * 10.0 ** -float(torch.randint(0, 10, (), generator=gen))}
        lr = 1e-3 * 0.9 ** it
        old = param
        new, new_state = adam_update(g, state, old, lr, b2=0.999)
        param, state = masked_update(do_step or it == 0, new, new_state,
                                     old, state)
        scales = tuple(torch.tensor(v) for v in adam_scales(
            state_.count + 1, 0.9, 0.999, "cpu"))
        d = do_step or it == 0
        if on_device:
            masked_adam_update_(g, state_, mine, torch.tensor(np.float32(lr)),
                                torch.tensor(d), scales, b2=0.999)
        else:
            masked_adam_update_(g, state_, mine, lr, d,
                                tuple(float(v) for v in scales), b2=0.999)
        state_.count += int(d)
        assert state_.count == state.count
        for k in param:
            assert torch.equal(param[k], mine[k]), it
            assert torch.equal(state.mu[k], state_.mu[k]), it
            assert torch.equal(state.nu[k], state_.nu[k]), it


def test_engages_on_a_card_alone():
    tr = _trainer("masked")
    cfg = StepConfig(H=16, W=16, n_views=4, rays_per_view=16, n_samples=64)
    blurred = StepConfig(H=16, W=16, n_views=4, rays_per_view=16,
                         n_samples=64, blur=BlurSpec("uniform-gaussian", 8))
    card = types.SimpleNamespace(device=torch.device("cuda"), mesh=None,
                                 state=tr.state)
    assert graph_step.engages(card, cfg)
    assert not graph_step.engages(card, blurred)
    assert not graph_step.engages(tr, cfg)                      # the CPU
    assert not graph_step.engages(
        types.SimpleNamespace(device=card.device, mesh=object(),
                              state=tr.state), cfg)
    # L2G's state, and bf16 factors
    assert not graph_step.engages(
        types.SimpleNamespace(device=card.device, mesh=None,
                              state=types.SimpleNamespace()), cfg)
    tr.state.field.density_planes[0].data = \
        tr.state.field.density_planes[0].data.bfloat16()
    assert not graph_step.engages(card, cfg)


def test_the_blur_cache_refreshes_in_place():
    """A refresh writes each scale's images and mask into the cache's own
    tensors (a captured step keeps reading them), with the values of a
    fresh build, and never into the sharp images."""
    args = ["--data.dataset=synthetic", "--data.image_size=[16,16]",
            "--data.n_views=4", "--max_iter=100", "--c2f_kernel_size=8",
            "--blur_2d_c2f_kernel_size=15"]
    opt = set_options("configs/bat_blender_VM.yaml", args)
    a, b = (Trainer(opt, load_dataset(opt, "train", device="cpu"),
                    device="cpu") for _ in range(2))
    sharp = a.images_sharp.clone()
    a.it = 10
    a._refresh_blur_cache()
    for it in (20, 30, 50, 90):
        a.it = b.it = it
        masks, images = dict(a.edge_masks), dict(a.blurred_images)
        a._refresh_blur_cache()
        b.blurred_images, b.edge_masks = {}, {}
        b._refresh_blur_cache()
        for sc in a.edge_masks:
            assert torch.equal(a.edge_masks[sc], b.edge_masks[sc])
            assert torch.equal(a.blurred_images[sc], b.blurred_images[sc])
            assert a.edge_masks[sc] is masks[sc]
            assert (a.blurred_images[sc] is images[sc]) or (
                a.blurred_images[sc] is a.images_sharp)
        assert torch.equal(a.images_sharp, sharp)
    # the blur ends at this schedule: every scale is the sharp images
    assert all(v is a.images_sharp for v in a.blurred_images.values())


def test_a_key_changed_before_its_capture_runs_as_train_step():
    """Where the last key changed before it was captured, StepGraphs hands
    the step back to train_step (None), and keeps doing so while the key
    keeps changing; nothing of the card is touched on that path."""
    tr = _trainer("masked")
    tr.run(max_iter=3, log_every=100)
    cfg = tr.last_step_config
    view_sel, ray_idx = torch.arange(2), torch.arange(8)
    graphs = graph_step.StepGraphs(dict(tr.graph_counts))
    graphs.current = types.SimpleNamespace(key=("another",), graph=None)
    s = step_lib.StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3)
    assert graphs.step(tr, cfg, view_sel, ray_idx, s) is None
    assert graphs.current is None
    first = graphs._unsettled
    # the next step's key differs again (another pose rate frozen): still
    # train_step's
    s0 = step_lib.StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=0.0)
    assert graphs.step(tr, cfg, view_sel, ray_idx, s0) is None
    assert graphs._unsettled != first and graphs.current is None


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


def _launches(fn) -> dict:
    before = dict(cuda_build.LAUNCHES)
    fn()
    return {k: n - before[k] for k, n in cuda_build.LAUNCHES.items()
            if n != before[k]}


def _gap(a: dict, b: dict) -> float:
    """The largest gap of two states' float leaves, over each leaf's
    largest magnitude."""
    worst = 0.0
    for k in a:
        if isinstance(a[k], torch.Tensor) and a[k].is_floating_point():
            scale = max(float(a[k].abs().max()), 1e-12)
            worst = max(worst, float((a[k] - b[k]).abs().max()) / scale)
    return worst


# on the card the 2D blur is off: its scales, drawn each step from a pool,
# give each step other images, hence another key (an eager step each)
CARD = ["--blur_2d=false"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_graphed_steps_follow_the_eager_ones(route, monkeypatch):
    """Iterations 7-11: the key's first step at 7 (after the mask update
    at 6), its capture at 8, replays at 9 and 10, a new key at 11 (the
    mask update at 10)."""
    _card()
    start = ROUTES[route][2]
    runs = []
    for graphed in (True, False, False):
        tr = _trainer(route, device="cuda", extra=CARD)
        tr.run(max_iter=start, log_every=100)
        if not graphed:
            monkeypatch.setattr(graph_step, "engages", lambda t, cfg: False)
        before = dict(tr.graph_counts)
        launches = []
        metrics = []
        for _ in range(5):
            launches.append(_launches(
                lambda: metrics.append(tr.train_iteration(stats=True))))
            tr._update_schedule()
            tr.it += 1
        monkeypatch.undo()
        counts = {k: tr.graph_counts[k] - before[k] for k in before}
        if graphed:
            assert counts == {"captures": 1, "replays": 3, "eager": 2}
        else:
            assert counts == {"captures": 0, "replays": 0, "eager": 5}
        # fresh metrics each step
        assert len({m["loss"].data_ptr() for m in metrics}) == 5
        runs.append(([float(m["loss"]) for m in metrics], _state(tr),
                     launches))
    (lg, sg, kg), (l1, s1, k1), (l2, s2, k2) = runs
    assert kg == k1 == k2, (kg, k1)
    spread = max(_gap(s1, s2), 1e-6)
    assert _gap(sg, s1) <= 10 * spread, (_gap(sg, s1), spread)
    np.testing.assert_allclose(lg, l1, rtol=1e-4)


@pytest.mark.cuda
def test_a_transition_captures_anew_and_a_replay_syncs_nowhere():
    _card()
    tr = _trainer("masked", device="cuda", extra=CARD)
    seen = []

    def on_step(t, m):
        if m is not None:
            seen.append((t.it, dict(t.graph_counts),
                         t.last_step_config.blur is not None))

    tr.run(log_every=100, on_step=on_step)
    by_it = {it: (c, blur) for it, c, blur in seen}
    # no graph under the blur (iterations 0-4 here)
    assert all(c["captures"] == c["replays"] == 0
               for c, blur in by_it.values() if blur) and any(
        blur for _, blur in by_it.values())
    # each shape's first step eager, then one capture and replays: the
    # upsample at 4 and the mask updates at 6 and 10 start new keys
    for it in (5, 7, 11):
        prev, now = by_it[it - 1][0], by_it[it][0]
        assert now["eager"] == prev["eager"] + 1, (it, prev, now)
        nxt = by_it[it + 1][0]
        assert nxt["captures"] == now["captures"] + 1, (it, now, nxt)
        assert nxt["replays"] == now["replays"] + 1
    assert tr._graphs.current is not None
    assert tr._graphs.current.graph is not None
    assert by_it[13][0]["captures"] == 3

    def step():
        tr.train_iteration()
        tr.it += 1
    tr.max_iter += 4
    by_span = {}
    tracing.count_syncs(step, 2, by_span=by_span)
    assert not [k for k in by_span if k.startswith("jt.")], by_span


@pytest.mark.cuda
def test_blur_and_cpu_steps_stay_eager():
    _card()
    tr = _trainer("masked", device="cuda")
    tr.run(max_iter=4, log_every=100)
    assert tr.graph_counts == {"captures": 0, "replays": 0, "eager": 4}
    cpu = _trainer("masked")
    cpu.run(max_iter=9, log_every=100)
    assert cpu.graph_counts == {"captures": 0, "replays": 0, "eager": 9}


@pytest.mark.cuda
def test_a_mesh_step_stays_eager(tmp_path):
    _card()
    import torch.distributed as dist

    from joint_tensorf_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(f"file://{tmp_path}/store", 1, 0, device="cuda")
    try:
        tr = _trainer("masked", device="cuda",
                      extra=["--tpu.mesh_shape=[1]"])
        tr.run(max_iter=9, log_every=100)
        assert tr.mesh is not None
        assert tr.graph_counts == {"captures": 0, "replays": 0, "eager": 9}
    finally:
        dist.destroy_process_group()


# the hand-written kernels by the name of their count in cuda_build.LAUNCHES
KERNEL_NAMES = {
    "composite_fwd": ("composite_fwd_kernel",),
    "composite_bwd": ("composite_bwd_kernel",),
    "scatter_add_rows": ("scatter_add_rows_narrow_kernel",
                         "scatter_add_rows_wide_kernel"),
    "scatter_add_rows_tiled": ("scatter_add_rows_tiled_kernel",),
    "binned_plane_scatter": ("binned_plane_scatter_kernel",),
    "density_sample_fwd": ("density_fwd_kernel",),
    "density_sample_bwd": ("density_bwd_kernel",),
    "app_sample_fwd": ("app_fwd_kernel",),
    "app_sample_bwd": ("app_bwd_kernel",)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_a_replay_runs_the_kernels_it_counts(route):
    """Three replayed steps under torch.profiler: each hand-written kernel
    the device ran as often as the replays' counts in cuda_build.LAUNCHES
    say (the capture's record, added at each replay), K1, K2, K6 and K7
    once each a step, and no other."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    tr = _trainer(route, device="cuda", extra=CARD)
    tr.run(max_iter=ROUTES[route][2] + 2, log_every=100)
    assert tr._graphs.current is not None
    assert tr._graphs.current.graph is not None
    tr.max_iter += 3
    before = dict(tr.graph_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        counted = _launches(lambda: [
            (tr.train_iteration(), setattr(tr, "it", tr.it + 1))
            for _ in range(3)])
        torch.cuda.synchronize()
    assert tr.graph_counts["replays"] - before["replays"] == 3
    assert tr.graph_counts["eager"] == before["eager"]
    ran = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k, names in KERNEL_NAMES.items():
            if any(n in e.name for n in names):
                ran[k] = ran.get(k, 0) + 1
    assert ran == counted, (ran, counted)
    for k in ("composite_fwd", "composite_bwd", "density_sample_fwd",
              "density_sample_bwd", "app_sample_fwd", "app_sample_bwd"):
        assert ran.get(k) == 3, (k, ran)


@pytest.mark.cuda
def test_a_key_that_moves_every_step_runs_eagerly():
    """With the 2D blur on, the masked route's whole run: a capture only
    where a key held, each capture replayed, every step counted once."""
    _card()
    tr = _trainer("masked", device="cuda")
    seen = []
    tr.run(log_every=100,
           on_step=lambda t, m: m is not None and seen.append(
               dict(t.graph_counts)))
    last = seen[-1]
    assert sum(last.values()) - last["captures"] == tr.max_iter
    assert last["captures"] <= last["replays"]
    for a, b in zip(seen, seen[1:]):
        if b["captures"] > a["captures"]:
            assert b["replays"] == a["replays"] + 1
