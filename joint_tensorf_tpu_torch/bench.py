"""Training-throughput benchmark of the port on one card (counterpart of the
repository's root bench.py).

    python -m joint_tensorf_tpu_torch.bench [--device=cpu]

Times BAT's whole training step (train/step.train_step: render, the joint
backward, both Adam updates) at the phases of bat_blender_VM.yaml's
headline schedule and prints ONE JSON line on stdout (progress goes to
stderr):

  {"metric": "rays_per_sec_train", "value": N, "unit": "rays/s",
   "vs_baseline": N / BASELINE_RAYS_PER_SEC, "detail": {...}}

The value is the rays of a step over the step time weighted by the share
of the schedule each phase takes (simulate_schedule_weights): compacted
70%, early 22.5%, dense 7.5%.  ``detail`` names the device the numbers
came from (its name, the device count and nvidia-smi's name and power
limit), each phase's median, its batch spread, and an analytic floor of
the compacted step against one H100's published peaks.

Shapes (the root bench's): 100 views of 400 x 400, 2048 rays a step (20 a
view: 2000), the VM field at VMConfig's defaults (ranks 16 / 48, app_dim
27, MLP_Fea 64 hidden) on a 400^3 grid, S 1000; early 128^3 at S 443.  The
phases, measured most important first (phase_setups):

  compacted  the alpha mask, K 256 kept slots, no blur, no dense grid;
             billed at app_k 192 (the auto-raised cap of the compacted
             phases) unless configs/base.yaml's tpu.app_k_dense_only
             (or JTF_BENCH_APPK_DENSE_ONLY) bills it without a cap; the
             app_k 64 and uncapped variants are in detail;
  early      128^3, S 443, the uniform-gaussian factor blur (kernel 64),
             the dense grid, app_k 64, the probed in-bbox budget;
  dense      400^3, S 1000, the blur and the dense grid, billed at the
             mean of the three blur-mask windows (the six-ball mask
             dilated at each window's radius, probed budgets; a window
             whose probe does not beat the bbox budget runs bbox-only).

The dense grid is the port's densify_density route (ops/densify.py); the
root bench's densify_impl="lane" picks one of two TPU layouts of that
sampler and has no counterpart here (train/step.StepConfig).

Each iteration draws its rays with numpy, as the root bench does; the
step's stochastic draws come from one torch.Generator on the device.
After every phase a complete record is written to
docs/bench/last_bench_torch.json (phases not measured yet carried from
an earlier record of the same shapes, or billed at the slowest known
phase, and listed as carried), so an interrupted run leaves what it
measured.  Only a whole run prints.

It runs on the card.  ``JTF_BENCH_SMALL=1`` with ``--device=cpu`` is the
CPU smoke mode (8 views of 64 x 64, 48^3, 256 rays, S 256, 2 x 2 steps a
phase, the kernels' plain versions): it walks the whole code path, its
numbers are not measurements, and it never writes the record.  Without a
card and without ``--device=cpu`` it raises; ``--device=cpu`` without the
smoke mode is refused.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
import yaml

from .data.synthetic import sphere_poses
from .geometry.rays import get_center_and_ray
from .models.alpha_mask import (AlphaMask, capped_mask_res, dilate_mask,
                                sample_alpha)
from .models.vm import VMConfig, init_vm
from .ops import cuda_build
from .render.renderer import BlurSpec, sample_ray
from .train.step import (StepConfig, StepScalars, TrainState,
                         init_train_state, train_step)
from .utils.torch_setup import resolve_device, setup_torch

# The root bench's estimate of the CUDA reference's training throughput of
# this workload on its RTX 3090-class GPU (BENCH_NOTES.md, "vs_baseline
# derivation"; the reference publishes no numbers).  Not a TPU number.
BASELINE_RAYS_PER_SEC = 12000.0

# One H100's published peaks (NVIDIA's data sheet, SXM part, at its 700 W
# limit): HBM3 bytes per second and float32 operations per second outside
# the tensor cores; the port runs float32 with TF32 off (setup_torch).
H100_HBM_BYTES_PER_SEC = 3.35e12
H100_F32_FLOP_PER_SEC = 67e12

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAST_GOOD = os.path.join(_REPO, "docs", "bench", "last_bench_torch.json")
_SMALL = os.environ.get("JTF_BENCH_SMALL") == "1"

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
# n_views, H, W, res, rays a step (before the per-view split), S, reps,
# iterations a rep
HEADLINE = (100, 400, 400, (400, 400, 400), 2048, 1000, 5, 10)
SMOKE = (8, 64, 64, (48, 48, 48), 256, 256, 2, 2)
APP_K = 64
APP_K_RAISED = 192
# worst-case sigma_world of the three blur-mask refresh windows (it
# 9000-12000): the schedule at each window's start x the scale pool's max
WINDOW_SIGMAS = (0.0525, 0.035, 0.0175)
BLUR_KERNEL = 64


def _probe_backend(timeout_s: float = 120.0, device="cuda") -> bool:
    """True if ``device`` answers a trivial op within ``timeout_s``; run
    in a daemon thread, so that a hung device cannot wedge the bench."""
    ok = [False]

    def _try():
        try:
            ok[0] = float(torch.ones((8, 8), device=device).sum()) == 64.0
        except RuntimeError as e:
            print(f"[bench] device probe failed: {e}", file=sys.stderr)

    t = threading.Thread(target=_try, daemon=True)
    t.start()
    t.join(timeout_s)
    return ok[0]


def simulate_schedule_weights(max_iter: int = 40000, seed: int = 0):
    """The phase weights, from simulating bat_blender_VM.yaml's schedule
    iteration by iteration (the root bench's draws, in its order).

    Blur is active when max(c2f_density * random_scale, c2f_color) >=
    1e-3 (the random scale multiplies the density parameter only); the
    alpha mask exists from update_alphamask_iters[0], and compaction runs
    when it exists and the blur is off; "early" is before the last
    upsample.  The schedules are 0 from progress 0.3 (it 12,000), when
    the mask arrives, so every later iteration is sharp and compacted.
    """
    sched_d = [0.3, 0.15, 0.07, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    sched_c = list(sched_d)
    scale_pool = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
    upsample_iters = [2000, 6000, 7500, 9000]
    first_mask_iter = 12000
    eps = 1e-3
    rng = np.random.default_rng(seed)

    def interp(x, sched):
        xs = np.linspace(0.0, 1.0, len(sched))
        return float(np.interp(x, xs, sched))

    counts = {"early": 0, "dense_blur": 0, "dense_sharp": 0, "compacted": 0}
    for it in range(max_iter):
        progress = it / max_iter
        d = interp(progress, sched_d) * float(rng.choice(scale_pool))
        c = interp(progress, sched_c)
        blur = max(d, c) >= eps
        if it < upsample_iters[-1]:
            counts["early"] += 1
        elif it >= first_mask_iter and not blur:
            counts["compacted"] += 1
        elif blur:
            counts["dense_blur"] += 1
        else:
            # final resolution, blur annealed, mask not built yet
            counts["dense_sharp"] += 1
    return {k: v / max_iter for k, v in counts.items()}


class _Capture:
    """Incremental result assembly and per-phase persistence.

    ``fresh`` maps a phase to its measurement in this run.  Missing
    phases are carried from the previous record when it was taken at the
    same shapes, else billed at the slowest known phase time; either way
    they are listed in ``carried_phases``.  ``extras`` joins ``detail``.
    The schedule is simulated once, when the capture starts.
    """

    PHASE_KEYS = {"compacted": "ms_compacted", "early": "ms_early",
                  "dense": "ms_dense"}

    def __init__(self, n_rays, shape_sig=None):
        self.n_rays = n_rays
        self.shape_sig = shape_sig
        self.fresh = {}
        self.extras = {}
        self.carried = {}
        self.weights = simulate_schedule_weights()
        if _SMALL:
            return
        try:
            with open(_LAST_GOOD) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            return
        det = prev.get("detail", {})
        # only phases measured at the same shapes are carried: a 300^3
        # dense time in a 400^3 headline is the rays/s of no workload
        prev_sig = [det.get("res"), det.get("n_rays"), det.get("n_samples")]
        if shape_sig is None or prev_sig == list(shape_sig):
            for ph, key in self.PHASE_KEYS.items():
                if det.get(key) is not None:
                    self.carried[ph] = {
                        "median_s": det[key] / 1000.0,
                        "captured_at": prev.get("captured_at", "unknown")}

    def phase_time(self, ph):
        if ph in self.fresh:
            return self.fresh[ph]["median_s"], False
        if ph in self.carried:
            return self.carried[ph]["median_s"], True
        return None, None

    def record(self, ph, measurement):
        self.fresh[ph] = measurement
        self.persist(partial=True)

    def result(self, partial):
        w = self.weights
        times, carried_phases = {}, []
        # a phase with neither a fresh nor a carried time is billed at the
        # slowest known phase time (understates the throughput)
        known = [self.phase_time(p)[0] for p in self.PHASE_KEYS
                 if self.phase_time(p)[0] is not None]
        worst = max(known) if known else None
        for ph in self.PHASE_KEYS:
            t, was_carried = self.phase_time(ph)
            if t is None:
                t, was_carried = worst, True
            times[ph] = t
            if was_carried:
                carried_phases.append(ph)
        if any(t is None for t in times.values()):
            return None
        t_mix = (w["early"] * times["early"]
                 + (w["dense_blur"] + w["dense_sharp"]) * times["dense"]
                 + w["compacted"] * times["compacted"])
        rays_per_sec = self.n_rays / t_mix
        detail = {self.PHASE_KEYS[ph]: round(times[ph] * 1000, 1)
                  for ph in self.PHASE_KEYS}
        detail["spread_ms"] = {
            ph: [round(m["min_s"] * 1000, 1), round(m["max_s"] * 1000, 1)]
            for ph, m in self.fresh.items()}
        detail["phase_weights_simulated"] = {k: round(v, 4)
                                             for k, v in w.items()}
        detail.update(self.extras)
        result = {
            "metric": "rays_per_sec_train",
            "value": round(rays_per_sec, 1),
            "unit": "rays/s",
            "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
            "detail": detail,
        }
        if partial or carried_phases:
            result["partial"] = bool(partial)
            result["carried_phases"] = carried_phases
            if carried_phases:
                result["note"] = (
                    "phases " + ",".join(carried_phases) + " carried from "
                    "a previous capture (this run was interrupted before "
                    "measuring them); fresh phases: "
                    + ",".join(sorted(self.fresh)))
        return result

    def persist(self, partial):
        if _SMALL:
            return  # smoke numbers must never become a record
        result = self.result(partial)
        if result is None:
            return
        try:
            os.makedirs(os.path.dirname(_LAST_GOOD), exist_ok=True)
            tmp = _LAST_GOOD + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dict(result, captured_at=time.strftime(
                    "%Y-%m-%dT%H:%M:%S%z")), f, indent=1)
            os.replace(tmp, _LAST_GOOD)
        except OSError as e:
            print(f"[bench] could not persist the record: {e}",
                  file=sys.stderr)
        return result


# ------------------------------------------------------------ the workload
@dataclasses.dataclass
class Workload:
    """What every phase shares: the shapes, the data (camera poses and
    intrinsics, images, edge masks), the step's scalars, the host
    generator of the ray draws and the device generator of the step's
    draws, and the budgets the probes chose.  ``windows``: the three
    blur-mask windows, each with the phase that measures it (None: billed
    at the bbox-only dense phase)."""
    device: torch.device
    n_views: int
    H: int
    W: int
    res: tuple
    n_samples: int
    reps: int
    iters: int
    rays_per_view: int
    vm_cfg: VMConfig
    rng: np.random.Generator
    gen: torch.Generator
    pose_base: torch.Tensor
    intr_inv: torch.Tensor
    images: torch.Tensor
    edges: torch.Tensor
    view_sel: torch.Tensor
    scalars: StepScalars
    mask_res: list
    compact_k: int
    bbox_k: Optional[int]
    app_k_raised: int
    windows: list

    @property
    def n_rays(self) -> int:
        return self.rays_per_view * self.n_views


@dataclasses.dataclass
class Phase:
    """One measured step: its StepConfig, the state it starts from (shared
    between phases; run a copy) and the alpha mask passed to train_step."""
    name: str
    cfg: StepConfig
    state: TrainState
    mask: Optional[AlphaMask]


def _intrinsics(n_views: int, H: int, W: int):
    """The Blender camera's intrinsics at W x H, for every view."""
    focal = 0.5 * 800 / np.tan(0.5 * 0.6911) * (W / 800)
    return np.broadcast_to(np.array(
        [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], dtype=np.float32),
        (n_views, 3, 3)).copy()


def probe_bbox_k(res_p, S, n_views, H, W, device, step_ratio=0.5,
                 stride=4, mask=None, pad=1.0):
    """The compaction budget of a phase: the most live sample groups of
    64 probe rays a view (one group per ``stride`` samples when S divides
    by it), unstratified, padded by ``pad`` and rounded up to 128; None
    when that reaches S.  Without ``mask`` a group lives when any of its
    samples is in the box; with it also when the mask is > 0 at its first
    sample (the renderer's group gate)."""
    prng = np.random.default_rng(7)
    poses = torch.as_tensor(sphere_poses(n_views), device=device)
    intr_inv = torch.linalg.inv(torch.as_tensor(_intrinsics(n_views, H, W),
                                                device=device))
    idx = torch.as_tensor(prng.permutation(H * W)[:64], device=device)
    c, d = get_center_and_ray(H, W, poses, intr_inv, ray_idx=idx)
    c, d = c.reshape(-1, 3), d.reshape(-1, 3)
    ab = torch.tensor(AABB, dtype=torch.float32, device=device).reshape(2, 3)
    units = (ab[1] - ab[0]) / (torch.tensor(res_p, dtype=torch.float32,
                                            device=device) - 1)
    step_sz = units.mean() * step_ratio
    g = stride if S % stride == 0 else 1
    pts, _, inb = sample_ray(ab, step_sz, S, c, d, 2.0, 6.0,
                             stratified=False)
    galive = inb.reshape(inb.shape[0], S // g, g).any(dim=-1)
    if mask is not None:
        first = pts[:, ::g].reshape(-1, 3)
        a = sample_alpha(mask, (first[:, 0], first[:, 1], first[:, 2]))
        galive = galive & (a.reshape(inb.shape[0], S // g) > 0)
    mx = int(galive.sum(dim=-1).max()) * g
    k = min(S, max(128, -(-int(mx * pad) // 128) * 128))
    return None if k >= S else k


def six_ball_mask(mask_res) -> np.ndarray:
    """The sharp occupancy of the blur-mask windows: six balls of radius
    0.25-0.45 centred in [-0.9, 0.9]^3, drawn from a generator seeded 11,
    on a ``mask_res`` grid spanning the box."""
    ball_rng = np.random.default_rng(11)
    axes = [np.linspace(-1.5, 1.5, m, dtype=np.float32) for m in mask_res]
    BX, BY, BZ = np.meshgrid(*axes, indexing="ij")
    sharp = np.zeros(tuple(mask_res), np.float32)
    for _ in range(6):
        cx, cy, cz = ball_rng.uniform(-0.9, 0.9, 3)
        rad = ball_rng.uniform(0.25, 0.45)
        sharp[(BX - cx) ** 2 + (BY - cy) ** 2 + (BZ - cz) ** 2
              < rad * rad] = 1.0
    return sharp


def _state(vm_cfg, res, n_views, device):
    field = init_vm(vm_cfg, res, AABB, torch.Generator().manual_seed(0))
    return init_train_state(field.to(device), n_views)


def phase_setups(small: bool, device) -> tuple[Workload, list[Phase]]:
    """The workload and every step ``main`` measures, in the order it
    measures them: compacted_appk64, compacted (app_k 192) and
    compacted_appknone_fused (not at the smoke shapes, where the raised
    cap is 64), early, dense (bbox only), then one phase per distinct
    budget of the blur-mask windows that beats the bbox budget
    (``dense_blur_mask_k<K>``)."""
    dev = torch.device(device)
    n_views, H, W, res, n_rays_total, S, reps, iters = (
        SMOKE if small else HEADLINE)
    vm_cfg = VMConfig()
    state = _state(vm_cfg, res, n_views, dev)
    rays_per_view = max(1, n_rays_total // n_views)

    def probe(res_p, S_p, **kw):
        return probe_bbox_k(res_p, S_p, n_views, H, W, dev,
                            vm_cfg.step_ratio, **kw)

    rng = np.random.default_rng(0)
    intr = torch.as_tensor(_intrinsics(n_views, H, W), device=dev)
    images = torch.as_tensor(rng.random((n_views, H * W, 3)),
                             dtype=torch.float32, device=dev)
    # mid-schedule blur widths (sigma_world 0.05); the compacted phases
    # run no blur and ignore them
    scalars = StepScalars(
        lr_index=1e-2, lr_basis=5e-4, lr_pose=1e-3, c2f_density=0.05,
        c2f_color=0.05, near_far=(2.0, 6.0), l1_weight=4e-5,
        tv_density_weight=0.0, tv_color_weight=0.0, use_edge=0.0,
        edge_factor=1.5, non_edge_factor=0.5, view_pe_progress=1.0,
        fea_pe_progress=1.0, pose_do_step=1.0, tv_depth_weight=0.0)

    # the compacted phases' mask at the trainer's capped build resolution
    mres = capped_mask_res(res) if not small else [32, 32, 32]
    occ = rng.random(tuple(mres)) < 0.001
    try:
        from scipy import ndimage

        occ = ndimage.binary_dilation(occ, iterations=8)
    except ImportError:
        pass
    alpha_mask = AlphaMask(grid=torch.as_tensor(occ.astype(np.float32),
                                                device=dev),
                           aabb=state.field.aabb)
    compact_k = min(256, S // 2)
    bbox_k = probe(res, S)
    app_k_raised = APP_K_RAISED if not small else APP_K
    print(f"[bench] mask res {mres}, dense bbox compact_k = {bbox_k}",
          file=sys.stderr)

    base = StepConfig(H=H, W=W, n_views=n_views,
                      rays_per_view=rays_per_view, n_samples=S,
                      pose_opt=True, densify_density=True, app_k=APP_K,
                      blur=None, compact_k=bbox_k)
    c64 = dataclasses.replace(base, compact_k=compact_k,
                              densify_density=False)
    phases = [Phase("compacted_appk64", c64, state, alpha_mask)]
    if app_k_raised != APP_K:
        phases += [
            Phase("compacted", dataclasses.replace(c64, app_k=app_k_raised),
                  state, alpha_mask),
            Phase("compacted_appknone_fused",
                  dataclasses.replace(c64, app_k=None), state, alpha_mask)]

    # the voxel schedule spends it 0-9000 at 64^3-400^3 with fewer
    # samples: modelled at 128^3 / 443
    res_e = (128, 128, 128) if not small else res
    S_e = 443 if not small else S
    blur = BlurSpec(mode="uniform-gaussian", kernel_size=BLUR_KERNEL)
    phases.append(Phase(
        "early", dataclasses.replace(base, n_samples=S_e, blur=blur,
                                     compact_k=probe(res_e, S_e)),
        _state(vm_cfg, res_e, n_views, dev), None))
    cfg_d = dataclasses.replace(base, blur=blur)
    phases.append(Phase("dense", cfg_d, state, None))

    # the blur-mask windows: the sharp mask dilated by the window's radius
    # in mask cells (sigma at the mask's resolution, capped by the
    # kernel's half-width in mask cells), its probed budget (pad 1.25)
    sigmas = [s / 10 for s in WINDOW_SIGMAS] if small else WINDOW_SIGMAS
    grid_scale = float(np.mean(np.asarray(res, np.float64) / 3.0))
    mask_scale = float(np.mean(np.asarray(mres, np.float64) / 3.0))
    sharp = AlphaMask(grid=torch.as_tensor(six_ball_mask(mres), device=dev),
                      aabb=state.field.aabb)
    halfw = max(1, int(np.ceil((BLUR_KERNEL // 2) * mask_scale
                               / grid_scale)))
    windows = []
    for sig in sigmas:
        r = max(1, min(halfw, int(np.ceil(5.0 * sig * mask_scale)) + 1))
        bm = dilate_mask(sharp, r)
        bk = probe(res, S, mask=bm, pad=1.25)
        if bbox_k is not None and bk is not None:
            bk = min(bk, bbox_k)
        if bk is not None and bbox_k is not None and bk >= bbox_k:
            bk = None   # no win over the bbox budget in this window
        name = None if bk is None else f"dense_blur_mask_k{bk}"
        if name is not None and all(p.name != name for p in phases):
            phases.append(Phase(name, dataclasses.replace(cfg_d,
                                                          compact_k=bk),
                                state, bm))
        windows.append({"sigma_world": sig, "radius_cells": r,
                        "compact_k_blur": bk,
                        "occupancy": float(bm.grid.mean()), "phase": name})
        print(f"[bench] dense blur-mask window sigma={sig}: dilated(r={r}) "
              f"occ {windows[-1]['occupancy']:.3f}, K = {bk}",
              file=sys.stderr)

    work = Workload(
        device=dev, n_views=n_views, H=H, W=W, res=tuple(res),
        n_samples=S, reps=reps, iters=iters, rays_per_view=rays_per_view,
        vm_cfg=vm_cfg, rng=rng,
        gen=torch.Generator(device=dev).manual_seed(0),
        pose_base=torch.as_tensor(sphere_poses(n_views), device=dev),
        intr_inv=torch.linalg.inv(intr), images=images,
        edges=torch.zeros((n_views, H * W), device=dev),
        view_sel=torch.arange(n_views, device=dev), scalars=scalars,
        mask_res=list(mres), compact_k=compact_k, bbox_k=bbox_k,
        app_k_raised=app_k_raised, windows=windows)
    return work, phases


# ---------------------------------------------------------- the measurement
def run_iter(work: Workload, phase: Phase, st, jitter=None):
    """One training step of ``phase`` on the state ``st`` (updated in
    place) on rays_per_view rays of every view, drawn with numpy as the
    root bench draws them; the step's draws come from ``work.gen`` unless
    ``jitter`` is given.  Returns train_step's (metrics, grads)."""
    idx = torch.as_tensor(work.rng.permutation(work.H * work.W)
                          [:work.rays_per_view].astype(np.int64),
                          device=work.device)
    return train_step(st, phase.cfg, work.vm_cfg, work.pose_base,
                      work.intr_inv, work.images, work.edges, work.view_sel,
                      idx, work.scalars, generator=work.gen, jitter=jitter,
                      alpha_mask=phase.mask)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(work: Workload, phase: Phase, iters=None, reps=None) -> dict:
    """Median of ``reps`` batches of ``iters`` steps, from a copy of the
    phase's state, after 3 warm-up steps (each synchronised).  A batch
    chains its steps through the state with one synchronise at its end,
    as a training loop that runs ahead of the device pays a step; timed
    with the host clock.  Returns the median, the fastest and slowest
    batch means (seconds), reps and iters."""
    iters = work.iters if iters is None else iters
    reps = work.reps if reps is None else reps
    st = copy.deepcopy(phase.state)
    for i in range(3):
        metrics, _ = run_iter(work, phase, st)
        float(metrics["loss"])
        _sync(work.device)
        print(f"[bench] {phase.name} warmup {i} ok", file=sys.stderr)
    batch_means = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics, _ = run_iter(work, phase, st)
        float(metrics["loss"])
        _sync(work.device)
        batch_means.append((time.perf_counter() - t0) / iters)
    batch_means.sort()
    med = batch_means[len(batch_means) // 2]
    print(f"[bench] {phase.name} batches (ms): "
          f"{[round(b * 1000, 1) for b in batch_means]} -> median "
          f"{med * 1000:.1f}", file=sys.stderr)
    return {"median_s": med, "min_s": batch_means[0],
            "max_s": batch_means[-1], "reps": reps, "iters": iters}


def roofline_compacted(n, K, K2, n_samples, res_xyz, t_step, card) -> dict:
    """Analytic floors of the compacted step against one H100's published
    peaks, from the root bench's census of its shapes: ``n`` rays, ``K``
    kept slots, ``K2`` shaded ones, ranks 16 / 48, a res_xyz^3 grid.
    Streamed bytes (the factors and their Adam state, the samples, the
    gathered and scattered rows) over the HBM rate, and the shading
    MLP's and the basis' float32 operations over the float32 peak;
    ``hbm_util`` is the byte floor over the measured ``t_step``, which is
    at most 1 while the census does not overcount; the rest of the step,
    divided by its row operations, is the effective time a row.  Without
    a card's ``t_step`` (None) both are "not measured"."""
    Rd, Ra = 16, 48
    rows_gather = 3 * n * K + 3 * n * K2   # density + appearance factors
    rows_probe = n * (n_samples // 4)      # the alpha probe at stride 4
    rows_scatter = 3 * n * K + 3 * n * K2  # the factors' gradient rows
    rows_total = rows_gather + rows_probe + rows_scatter
    row_bytes = (3 * n * K * (4 * Rd) * 4          # density corner rows
                 + 3 * n * K2 * (4 * Ra) * 4) * 2  # appearance, fwd + bwd
    params = 3 * res_xyz * res_xyz * (Rd + Ra) + 3 * res_xyz * (Rd + Ra)
    bytes_streamed = (params * 4 * 6 + 2 * params * 4
                      + n * n_samples * 4 * 6 + row_bytes)
    t_hbm_floor = bytes_streamed / H100_HBM_BYTES_PER_SEC
    flops = (2 * n * K2 * (150 * 64 + 64 * 64 + 64 * 3) * 3
             + 2 * n * K2 * (3 * Ra) * 27 * 3)
    t_f32 = flops / H100_F32_FLOP_PER_SEC
    measured = t_step is not None
    t_row = max(t_step - t_hbm_floor - t_f32, 0.0) if measured else None
    return {
        "model": "analytic floors + measured row-op residual",
        "peaks": {"hbm_bytes_per_s": H100_HBM_BYTES_PER_SEC,
                  "f32_flop_per_s": H100_F32_FLOP_PER_SEC,
                  "of": "one H100 SXM (data sheet, 700 W)", "card": card},
        "streamed_bytes_per_step": bytes_streamed,
        "f32_flop_per_step": flops,
        "t_hbm_floor_ms": round(t_hbm_floor * 1e3, 3),
        "t_f32_flop_floor_ms": round(t_f32 * 1e3, 3),
        "hbm_util": (round(t_hbm_floor / t_step, 4) if measured
                     else "not measured"),
        "rows_per_step": rows_total,
        "effective_ns_per_row": (round(t_row / rows_total * 1e9, 1)
                                 if measured else "not measured"),
    }


def device_detail(device, small: bool) -> dict:
    """The device the numbers came from: on a card its name, the device
    count and nvidia-smi's name and power limit; "cpu" otherwise, with
    the note that a CPU run measures nothing."""
    if device.type != "cuda":
        return {"device": "cpu",
                "device_note": "CPU smoke run (JTF_BENCH_SMALL=1, the "
                               "kernels' plain versions): its numbers are "
                               "not measurements"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"nvidia-smi not read: {e}"]
    index = device.index or 0
    out = {"device": torch.cuda.get_device_name(device),
           "device_count": torch.cuda.device_count(),
           "nvidia_smi": smi[index] if len(smi) > index else None}
    if small:
        out["device_note"] = ("smoke shapes (JTF_BENCH_SMALL=1): not the "
                              "headline workload")
    return out


def _app_k_dense_only() -> bool:
    """Whether the compacted phase is billed without an app_k cap:
    configs/base.yaml's tpu.app_k_dense_only, JTF_BENCH_APPK_DENSE_ONLY
    over it."""
    with open(os.path.join(_REPO, "configs", "base.yaml")) as f:
        shipped = bool(yaml.safe_load(f)["tpu"].get("app_k_dense_only",
                                                   False))
    return bool(int(os.environ.get("JTF_BENCH_APPK_DENSE_ONLY",
                                   str(int(shipped)))))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m joint_tensorf_tpu_torch.bench",
        description="BAT's schedule-weighted training throughput "
                    "(one JSON line)")
    ap.add_argument("--device", default=None,
                    help="the card (default) or cpu, with JTF_BENCH_SMALL=1")
    dev = resolve_device(ap.parse_args(argv).device)
    if dev.type != "cuda" and not _SMALL:
        print("[bench] --device=cpu runs only the smoke mode "
              "(JTF_BENCH_SMALL=1): a CPU run is no measurement",
              file=sys.stderr)
        return 2
    setup_torch()
    if not _probe_backend(device=dev):
        print(f"[bench] {dev} did not answer a trivial op", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if dev.type == "cuda":
        cuda_build.build_all()
        torch.cuda.reset_peak_memory_stats(dev)
    build_s = time.perf_counter() - t0

    work, phases = phase_setups(_SMALL, dev)
    by_name = {p.name: p for p in phases}
    n_rays, app_k = work.n_rays, APP_K
    cap = _Capture(n_rays, shape_sig=(list(work.res), n_rays,
                                      work.n_samples))
    cap.extras.update(device_detail(dev, _SMALL))
    cap.extras["build_s"] = round(build_s, 1)

    # phase 1 (70% of the schedule): compacted, measured first
    m_compact64 = measure(work, by_name["compacted_appk64"])
    cap.extras.update({"median_of": m_compact64["reps"],
                       "compact_k": work.compact_k, "n_rays": n_rays,
                       "n_samples": work.n_samples, "res": list(work.res),
                       "mask_res": work.mask_res,
                       "ms_compacted_appk64": round(
                           m_compact64["median_s"] * 1000, 1)})
    cap.record("compacted", m_compact64)
    m_compact = m_compact64
    if "compacted" in by_name:
        m_compact = measure(work, by_name["compacted"])
        cap.extras["app_k_compacted"] = work.app_k_raised
        cap.record("compacted", m_compact)
        m_cn = measure(work, by_name["compacted_appknone_fused"])
        cap.extras["ms_compacted_appknone_fused"] = round(
            m_cn["median_s"] * 1000, 1)
        if _app_k_dense_only():
            m_compact = m_cn
            cap.extras["app_k_compacted"] = None
            cap.record("compacted", m_cn)
        cap.persist(partial=True)
    t_compact = m_compact["median_s"]
    print(f"[bench] compact {t_compact * 1000:.1f} ms (app_k="
          f"{cap.extras.get('app_k_compacted', app_k)})", file=sys.stderr)

    # the floors of the step the headline bills: app_k 192 two-stage, or
    # the fused appearance over all K
    K2 = (work.compact_k if cap.extras.get("app_k_compacted",
                                           work.app_k_raised) is None
          else work.app_k_raised)
    cap.extras["roofline_compacted"] = roofline_compacted(
        n_rays, work.compact_k, K2, work.n_samples, work.res[0],
        t_compact if dev.type == "cuda" else None,
        cap.extras.get("nvidia_smi", cap.extras["device"]))
    cap.persist(partial=True)

    # phase 2 (22.5%): early
    cap.record("early", measure(work, by_name["early"]))

    # phase 3 (7.5%): dense, blurred; billed at the bbox-only rate until
    # the windows are measured, then at their mean
    m_dense_bbox = measure(work, by_name["dense"])
    cap.record("dense", m_dense_bbox)
    win_rows, k_times = [], {}
    for w in work.windows:
        if w["phase"] is None:
            t_w = m_dense_bbox["median_s"]
        else:
            if w["phase"] not in k_times:
                k_times[w["phase"]] = measure(
                    work, by_name[w["phase"]])["median_s"]
            t_w = k_times[w["phase"]]
        win_rows.append({k: w[k] for k in ("sigma_world", "radius_cells",
                                           "compact_k_blur")}
                        | {"ms": round(t_w * 1000, 1)})
        t_dense = float(np.mean(
            [r["ms"] for r in win_rows]
            + [m_dense_bbox["median_s"] * 1000.0] * (len(work.windows)
                                                     - len(win_rows))
        )) / 1000.0
        cap.extras["dense_blur_mask"] = {
            "enabled": any(r["compact_k_blur"] is not None
                           for r in win_rows),
            "windows": win_rows, "compact_k_bbox": work.bbox_k,
            "ms_dense_bbox_only": round(m_dense_bbox["median_s"] * 1000, 1)}
        cap.fresh["dense"] = dict(m_dense_bbox, median_s=t_dense)
        cap.persist(partial=True)
    if dev.type == "cuda":
        cap.extras["peak_gb"] = round(
            torch.cuda.max_memory_allocated(dev) / 1e9, 2)

    result = cap.result(partial=False)
    cap.persist(partial=False)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
