#!/usr/bin/env python
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--profile DIR]

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from joint_tensorf_tpu_torch/csrc (one nvcc per
   source, in parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version at the shapes of
   the training step (compositor K1/K2 with saturated rays included, K2
   without g_weights as the dense appearance path calls it and with them,
   as the two-stage appearance does; the row scatter K3 also at a
   160k-row destination), and times the kernel (back to back, and K1/K2's
   device time from torch.profiler), the plain version and, where one
   exists, the one PyTorch call that computes the same function (K3:
   index_add_);
4. holds K4 (the tile-binned plane-gradient scatter) and K5 (the
   block-local row scatter) against their plain versions at the JAX
   bench scripts' shapes (K4 also at a 400x400 plane with 2.03M samples in
   march order and with every sample in one cell, exactly; K5 also with
   every sample in one row, and with int32 indices), and times them (the
   route back to back and its kernels' device time by torch.profiler, and
   the accumulate kernel alone), their plain versions, the library calls
   (K4: grid_sample's plane gradient; K5: index_add_) and K3 at K5's
   shapes; both routes run under torch's sync debug mode "error" (which
   sees the torch calls of their glue, not the ctypes launches);
5. runs one small train step on the card and on the CPU (plain versions)
   from the same state and compares loss and gradients: on the dense path,
   with in-bbox compaction, the dense-grid density and app_k below the
   gated count under the blur, and with an alpha mask, group compaction
   and app_k;
6. drives K4 and K5 through their own entry points (sample_plane_binned
   forward + backward, scatter_add_rows_tiled), counters zeroed just
   before and read just after each: each must launch once;
7. trains BAT's first phase at full width (configs/bat_blender_VM.yaml on
   the procedural scene: 400x400, 12 views, 2028 rays x 221 samples, VM
   ranks 16/48) for 20 iterations through Trainer.run on the default
   tpu: path (the dense-grid density, two-stage appearance, the in-bbox
   budget), with the launch counters zeroed just before and read just
   after: every step must launch what its configuration calls for
   (expected_launches: K1 = 1, K2 = 1, K3 = 4 with the dense grid); then
   K3 at that path's own shapes (the dense grid's rows, the appearance
   planes);
8. trains BAT at full width through every phase, with the schedule cut to
   40 iterations (PHASES_ARGS: upsamples after iterations 2, 4, 6, 8,
   mask updates after 7 and 14): 64^3 -> 101^3 -> 160^3 -> 252^3, the
   uncapped mask and bbox shrink, the 64M-voxel grid in the shrunk box,
   the capped mask, S up to 1000; twice: on the default tpu: path, and
   with the alternatives off (ALTERNATIVES_OFF: the slices before this
   one's path, except that the alpha mask's own budget compacts, as it
   does in the JAX trainer).  A fresh field's density stays below the
   alpha threshold for far longer than such a schedule runs (its mask
   keeps nothing after 7 iterations and spans the whole box after 40), so
   the density factors start raised over the cores of the scene's blobs
   (warm_start_density; sparser than a trained field, so the gaps between
   the paths hold for this field only).  Checks every transition, every
   step's launches against its configuration, finite losses, that the
   mask culls samples once the blur is off, and on the default path that
   the masked last phase compacts (compact_k < S) and the blurred phases
   use the dense grid; prints each transition and one line per phase
   (budgets, the step's choices, kept and live fractions, launches,
   median step) and the peak memory; with --profile, two blurred
   dense-grid steps at the 64M-voxel grid and the last 3 steps of the
   default path run under torch.profiler;
9. holds K1/K2/K3 against their plain versions again at the shapes of
   each path's last phase (the compacted samples, the density and
   appearance planes' scatters; S = 1000 and the fused planes with the
   alternatives off) and K3 at the blurred phase's dense grid of 64M
   voxels, and times them there (K3's memset and kernel apart, by
   torch.profiler);
10. prints one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.

Any failed check raises and the script exits non-zero without the last
line.  It needs one CUDA card and exits 2 without one.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
N_STEPS = 20                    # full-width training steps on the main path
# BAT's schedule cut to 40 iterations: upsamples after 2, 4, 6, 8, mask
# updates after 7 (uncapped at 252^3: the bbox shrink) and 14 (capped);
# the blur ends at iteration 12 (progress 0.3)
PHASES_ARGS = ["--data.dataset=synthetic", "--max_iter=40",
               "--train_schedule.upsample_iters=[2,4,6,8]",
               "--train_schedule.update_alphamask_iters=[7,14]"]
# the JAX trainer's tpu: alternatives off: no in-bbox or blur-mask budget,
# the factored density, dense appearance; the alpha mask's budget stays
# (the JAX trainer probes it at every mask update, with no switch)
ALTERNATIVES_OFF = ["--tpu.bbox_compact=false", "--tpu.blur_mask_compact=false",
                    "--tpu.densify_density=false", "--tpu.app_k=null"]
# added to one density component per blob over +-WARM_RADII blob radii:
# the masked phases' budgets come out of the order the JAX trainer records
# for Blender (K 256-640 of S = 1000), with far fewer live samples a ray
WARM_DENSITY = 2.0
WARM_RADII = 0.5


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_times(fn, reps: int = 20, warmup: int = 3) -> dict:
    """Mean device time of one call from torch.profiler (CUPTI), by device
    activity (kernel or memset): {short name: ms} over ``reps`` calls.  An
    activity's mean is taken over the events recorded (a lost event does
    not lower it), times how many a call launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:48]
            per_call = max(1, round(e.count / reps))
            times[name] = times.get(name, 0.0) + \
                e.self_device_time_total / e.count * per_call / 1e3
    return times


def device_ms(fn, match: str) -> float:
    """Summed device time of one call's kernels whose name contains
    ``match``."""
    return sum(ms for name, ms in device_times(fn).items() if match in name)


def max_err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


# ------------------------------------------------------------ kernel checks
def composite_inputs(N, S, gen):
    """Alpha, rgb, z and cotangents at the step's shape; a few rays are
    saturated (alpha == 1.0 exactly) or fully transparent."""
    import torch

    dev = "cuda"
    alpha = torch.rand((N, S), generator=gen, device=dev) ** 4 * 0.5
    alpha[0] = 1.0
    alpha[1, ::3] = 1.0
    alpha[2] = 0.0
    rgb = torch.rand((N, S, 3), generator=gen, device=dev)
    z = 2.0 + torch.cumsum(torch.full((N, S), 0.024, device=dev), -1)
    cots = (torch.randn((N, 3), generator=gen, device=dev),
            torch.randn((N,), generator=gen, device=dev),
            torch.randn((N,), generator=gen, device=dev),
            torch.randn((N, S), generator=gen, device=dev))
    return alpha, rgb, z, cots


def check_composite(N, S, thres, gen, tol):
    """K1 and K2 against their plain versions (K2 given K1's weights, once
    with g_weights None, as the dense appearance calls it, and once with
    them, as the two-stage appearance of the default tpu: path does);
    times each back to back and, from torch.profiler, on the device.
    Returns the rows [K1, K2 without g_weights, K2 with them]."""
    import torch

    from joint_tensorf_tpu_torch.ops import composite as C

    alpha, rgb, z, cots = composite_inputs(N, S, gen)
    w = C.composite_fwd_cuda(alpha, rgb, z, thres)[3]   # the forward's
    NS = N * S
    # K1: alpha, rgb, z in; rgb_map, depth, acc, weights out
    checks = [("composite_fwd", None,
               lambda: C.composite_fwd_cuda(alpha, rgb, z, thres),
               lambda: C.composite_fwd_plain(alpha, rgb, z, thres),
               NS * 4 * (1 + 3 + 1) + NS * 4 + N * 4 * 5, NS * 13, 138)]
    for g_w in (None, cots[3]):
        args = (alpha, rgb, z, w, thres, *cots[:3], g_w)
        # K2: alpha, rgb, z, weights (and g_weights), g_rgb, g_depth, g_acc
        # in; d_alpha, d_rgb, d_z out
        n_in = 6 if g_w is None else 7
        checks.append(("composite_bwd", g_w is not None,
                       lambda args=args: C.composite_bwd_cuda(*args),
                       lambda args=args: C.composite_bwd_plain(*args),
                       NS * 4 * n_in + N * 4 * 5 + NS * 4 * 5, NS * 30, 189))
    rows = []
    for name, g_weights, kfn, pfn, n_bytes, flops, src_line in checks:
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in got):
            fail(f"{name} produced non-finite values")
        err = max_err(got, want)
        if err > tol:
            fail(f"{name} (g_weights given: {g_weights}) disagrees with its "
                 f"plain version at {(N, S)}: {err:.3g} > {tol}")
        b_ms, b_by = bound(n_bytes, flops)
        row = {
            "name": name, "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/composite.cu",
            "replaces": f"joint_tensorf_tpu/ops/pallas_kernels.py:{src_line}",
            "launches": None, "max_abs_err": err, "tolerance": tol,
            "ms": time_ms(kfn), "device_ms": device_ms(kfn, name + "_kernel"),
            "plain_ms": time_ms(pfn),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"N": N, "S": S, "thres": thres}}
        if g_weights is not None:
            row["g_weights"] = ("given (two-stage app_k)" if g_weights
                                else "none (dense appearance)")
        rows.append(row)
    return rows


def march_points(n_rays, S, H, W, gen):
    """Continuous plane positions (x, y) [n_rays * S] in march order: each
    ray's samples step across the plane by at most half a cell, like the
    training step's samples (step = half a voxel)."""
    import torch

    dev = "cuda"
    start = torch.rand((n_rays, 2), generator=gen, device=dev) \
        * torch.tensor([W - 1.0, H - 1.0], device=dev)
    ang = torch.rand((n_rays,), generator=gen, device=dev) * 2 * math.pi
    speed = 0.5 * torch.rand((n_rays, 1), generator=gen, device=dev)
    step = torch.stack([torch.cos(ang), torch.sin(ang)], -1) * speed
    t = torch.arange(S, device=dev, dtype=torch.float32)[None, :, None]
    pos = start[:, None, :] + t * step[:, None, :]
    return (pos[..., 0].clamp(0, W - 1.001).reshape(-1),
            pos[..., 1].clamp(0, H - 1.001).reshape(-1))


def march_indices(n_rays, S, H, W, gen):
    """Plane-row indices of march_points."""
    x, y = march_points(n_rays, S, H, W, gen)
    return (y.floor().long() * W + x.floor().long()).contiguous()


def march_indices_3d(n_rays, S, X, Y, Z, gen):
    """Row indices (x * Y + y) * Z + z of a dense [X, Y, Z] grid along
    rays in march order, each step at most half a cell per axis (the dense
    grid's row gather)."""
    import torch

    dev = "cuda"
    size = torch.tensor([X - 1.0, Y - 1.0, Z - 1.0], device=dev)
    start = torch.rand((n_rays, 3), generator=gen, device=dev) * size
    step = (torch.rand((n_rays, 3), generator=gen, device=dev) - 0.5)
    t = torch.arange(S, device=dev, dtype=torch.float32)[None, :, None]
    pos = torch.minimum((start[:, None] + t * step[:, None]).clamp(min=0),
                        size - 0.001).floor().long()
    return ((pos[..., 0] * Y + pos[..., 1]) * Z + pos[..., 2]).reshape(-1)


def expected_launches(cfg) -> dict:
    """Launches of one training step with StepConfig ``cfg``: K1 and K2
    once; K3 once per factor sample's backward (three fused planes, or
    three density and three appearance planes with the two-stage
    appearance) and once for the dense grid's row gather (then only the
    three appearance planes are factor samples)."""
    if cfg.densify_density:
        k3 = 1 + 3
    else:
        k3 = 6 if cfg.app_k is not None else 3
    return {"composite_fwd": 1, "composite_bwd": 1, "scatter_add_rows": k3,
            "binned_plane_scatter": 0, "scatter_add_rows_tiled": 0}


def check_scatter(n_rays, S, H, W, C, gen, tol, grid3d=None):
    """K3 on n_rays x S rows of C channels into an H x W plane in march
    order, or, with grid3d = (X, Y, Z), into the dense grid's X*Y*Z rows;
    times the wrapper back to back and, from torch.profiler, its memset
    and its kernel apart (device_ms_by_kernel; device_ms is the kernel's)."""
    import torch

    from joint_tensorf_tpu_torch.ops import segment_scatter as K

    if grid3d is None:
        idx = march_indices(n_rays, S, H, W, gen)
    else:
        idx = march_indices_3d(n_rays, S, *grid3d, gen)
        H, W = grid3d[0] * grid3d[1], grid3d[2]
    upd = torch.randn((idx.shape[0], C), generator=gen, device="cuda")
    n_rows = H * W
    got = K.scatter_add_rows_cuda(idx, upd, n_rows)
    want = K.scatter_add_rows_plain(idx, upd, n_rows)
    torch.cuda.synchronize()
    # atomics on both sides sum in run-dependent orders: compare relative
    # to the largest destination value
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"scatter kernel disagrees with index_add_ at {n_rows} rows: "
             f"{err:.3g} > {tol} x {scale:.3g}")
    del got, want
    N = idx.shape[0]
    b_ms, b_by = bound(N * 8 + N * C * 4 + n_rows * C * 4, N * C)

    def k3():
        return K.scatter_add_rows_cuda(idx, upd, n_rows)

    # the plain version is index_add_, which is also the library call;
    # the profiler runs last, so that no timing follows its teardown
    k3_ms = time_ms(k3)
    plain = time_ms(lambda: K.scatter_add_rows_plain(idx, upd, n_rows))
    library = time_ms(lambda: torch.zeros(
        (n_rows, C), device="cuda").index_add_(0, idx, upd))
    # the wrapper's device activities by name: its memset and the kernel
    by_kernel = device_times(k3)
    return {"name": "scatter_add_rows", "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/segment_scatter.cu",
            "replaces": "joint_tensorf_tpu/ops/segment_scatter.py:168",
            "launches": None, "max_abs_err": err,
            "tolerance": f"{tol} x max|out| = {tol * scale:.3g}",
            "ms": k3_ms,
            "device_ms": sum(t for name, t in by_kernel.items()
                             if "scatter_add_rows" in name),
            "device_ms_by_kernel": by_kernel,
            "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library,
            "shape": {"N": N, "C": C, "n_rows": n_rows,
                      "rows": "dense grid" if grid3d else "plane"}}


def check_binned(H, W, R, N, gen, tol, samples="uniform"):
    """K4 against its plain version on N samples: "uniform" in [-1, 1],
    "march" (2028 rays of N / 2028 samples in march order) or "one_cell"
    (every sample at one point of a 257 x 257 plane whose fractions are
    dyadic, g small integers: every partial sum is exact, so the kernel
    must equal the plain version).  The route runs once under sync debug
    mode "error", which sees its torch calls (allocation, .contiguous) but
    not its ctypes launches; that it never waits on the host is read from
    ops/binned_scatter.py (sizes from N, H, W and R alone, no .item()).
    Times the route (bucketing + accumulate) back to back and, from
    torch.profiler, its kernels' summed device time (device_ms, and by
    kernel); the accumulate kernel alone on a prebuilt bucketing
    (kernel_ms, kernel_device_ms); the plain version; and the library call,
    grid_sample's plane gradient, after checking that it computes the same
    function."""
    import torch
    import torch.nn.functional as F

    from joint_tensorf_tpu_torch.ops import binned_scatter as K

    dev = "cuda"
    if samples == "march":
        x, y = march_points(2028, N // 2028, H, W, gen)
        u, v = x * (2.0 / (W - 1)) - 1.0, y * (2.0 / (H - 1)) - 1.0
    elif samples == "one_cell":     # x = 5.5, y = 7.25 exactly
        if H != 257 or W != 257:
            fail(f"the one-cell case needs a 257 x 257 plane, got {H, W}")
        u = torch.full((N,), 5.5 / 128 - 1, device=dev)
        v = torch.full((N,), 7.25 / 128 - 1, device=dev)
        tol = 0.0
    else:
        u = torch.rand((N,), generator=gen, device=dev) * 2 - 1
        v = torch.rand((N,), generator=gen, device=dev) * 2 - 1
    if samples == "one_cell":
        g = torch.randint(-4, 5, (N, R), generator=gen, device=dev).float()
    else:
        g = torch.randn((N, R), generator=gen, device=dev)
    bins = K.pixel_bins(u, v, H, W)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.plane_grad_scatter_cuda(g, *bins, H, W)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = K.plane_grad_scatter_plain(g, *bins, H, W)
    # the library call: grid_sample's gradient w.r.t. its input plane
    plane = torch.zeros((1, R, H, W), device=dev, requires_grad=True)
    grid = torch.stack([u, v], -1)[None, :, None, :]
    out = F.grid_sample(plane, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    g_lib = g.T.contiguous()[None, :, :, None]

    def lib():
        return torch.autograd.grad(out, plane, g_lib, retain_graph=True)[0]

    lib_grad = lib()[0].permute(1, 2, 0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_lib = float((lib_grad - want).abs().max())
    scale = float(want.abs().max())
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"K4 disagrees with its plain version at {(H, W, R, N)}, "
             f"{samples}: {err:.3g} > {tol} x {scale:.3g}")
    if err_lib > 1e-5 * scale:
        fail(f"grid_sample's plane gradient is not K4's function at "
             f"{(H, W, R, N)}: {err_lib:.3g} > 1e-5 x {scale:.3g}")
    bk, buf = K.bucket_by_tile(bins[0], bins[1], H, W, R)
    # g, u and v read once (8 B per sample), d_plane written once
    b_ms, b_by = bound(N * R * 4 + N * 8 + H * W * R * 4, 8 * N * R)

    def route():
        return K.plane_grad_scatter_cuda(g, *bins, H, W)

    def accumulate():
        return K.accumulate(g, bk, buf, bins[2], bins[3])

    by_kernel = device_times(route)
    return {"name": "binned_plane_scatter", "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/binned_scatter.cu",
            "replaces": "joint_tensorf_tpu/ops/binned_scatter.py:163",
            "launches": None, "max_abs_err": err,
            "tolerance": f"{tol} x max|out| = {tol * scale:.3g}",
            "ms": time_ms(route), "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": by_kernel,
            "kernel_ms": time_ms(accumulate),
            "kernel_device_ms": device_ms(accumulate,
                                          "binned_plane_scatter_kernel"),
            "plain_ms": time_ms(
                lambda: K.plane_grad_scatter_plain(g, *bins, H, W)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib), "library_max_abs_err": err_lib,
            "shape": {"H": H, "W": W, "R": R, "N": N, "samples": samples}}


def check_tiled(N, n_rows, C, gen, tol, case="uniform"):
    """K5 against its plain version (index_add_, also the library call);
    case "uniform" (random rows), "int32" (the same with int32 indices) or
    "one_row" (every sample into one row: one bucket of many chunks; the
    updates are small integers, so both sums are exact and must be equal).
    The route runs once under sync debug mode "error", which sees its
    torch calls (allocation, .contiguous) but not its ctypes launches; that
    it never waits on the host is read from ops/tile_scatter.py (sizes from
    N, n_rows and C alone, no .item()).  Times the route
    (bucketing + accumulate) back to back and, from torch.profiler, its
    kernels' summed device time (device_ms, and by kernel); the accumulate
    kernel alone on a prebuilt bucketing (kernel_ms, kernel_device_ms);
    index_add_; and K3 on the same inputs."""
    import torch

    from joint_tensorf_tpu_torch.ops import segment_scatter as K3
    from joint_tensorf_tpu_torch.ops import tile_scatter as K

    if case == "one_row":
        idx = torch.full((N,), 7, device="cuda")
        upd = torch.randint(-4, 5, (N, C), generator=gen,
                            device="cuda").float()
        tol = 0.0
    else:
        idx = torch.randint(0, n_rows, (N,), generator=gen, device="cuda")
        upd = torch.randn((N, C), generator=gen, device="cuda")
    if case == "int32":
        idx = idx.int()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.scatter_add_rows_tiled_cuda(idx, upd, n_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = K.scatter_add_rows_tiled_plain(idx, upd, n_rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"K5 disagrees with index_add_ at {(N, n_rows, C, case)}: "
             f"{err:.3g} > {tol} x {scale:.3g}")
    bucketed = K.bucket_by_block(idx, n_rows, C)
    idx64 = idx.long()   # K3 takes int64 indices
    plain = time_ms(lambda: K.scatter_add_rows_tiled_plain(idx, upd, n_rows))
    b_ms, b_by = bound(N * idx.element_size() + N * C * 4 + n_rows * C * 4,
                       N * C)

    def route():
        return K.scatter_add_rows_tiled_cuda(idx, upd, n_rows)

    def accumulate():
        return K.accumulate(upd, *bucketed, n_rows)

    by_kernel = device_times(route)
    return {"name": "scatter_add_rows_tiled", "route": "cuda",
           "source": "joint_tensorf_tpu_torch/csrc/tile_scatter.cu",
           "replaces": "joint_tensorf_tpu/ops/tile_scatter.py:155",
           "launches": None, "max_abs_err": err,
           "tolerance": f"{tol} x max|out| = {tol * scale:.3g}",
           "ms": time_ms(route), "device_ms": sum(by_kernel.values()),
           "device_ms_by_kernel": by_kernel,
           "kernel_ms": time_ms(accumulate),
           "kernel_device_ms": device_ms(accumulate,
                                         "scatter_add_rows_tiled_kernel"),
           "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": plain,
           "k3_ms": time_ms(lambda: K3.scatter_add_rows_cuda(
               idx64, upd, n_rows)),
           "shape": {"N": N, "n_rows": n_rows, "C": C, "case": case}}


def run_entry_points(gen):
    """K4 and K5 lie on no trainer path (in the JAX package either): drive
    each through its own public entry point, with the counters zeroed
    just before and read just after."""
    import torch

    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.ops.binned_scatter import sample_plane_binned
    from joint_tensorf_tpu_torch.ops.tile_scatter import scatter_add_rows_tiled

    H = W = 400
    x, y = march_points(2028, 1000, H, W, gen)
    u = (x * (2.0 / (W - 1)) - 1.0).requires_grad_(True)
    v = (y * (2.0 / (H - 1)) - 1.0).requires_grad_(True)
    plane = torch.randn((H, W, 64), generator=gen, device="cuda",
                        requires_grad=True)
    g = torch.randn((u.shape[0], 64), generator=gen, device="cuda")
    idx = torch.randint(0, 90000, (524288,), generator=gen, device="cuda")
    upd = torch.randn((524288, 64), generator=gen, device="cuda")
    torch.cuda.synchronize()

    cuda_build.reset_launches()
    out = sample_plane_binned(plane, u, v)
    d_plane, d_u, d_v = torch.autograd.grad(out, (plane, u, v), g)
    torch.cuda.synchronize()
    k4 = dict(cuda_build.LAUNCHES)
    cuda_build.reset_launches()
    rows = scatter_add_rows_tiled(idx, upd, 90000)
    torch.cuda.synchronize()
    k5 = dict(cuda_build.LAUNCHES)
    if not all(torch.isfinite(t).all() for t in (d_plane, d_u, d_v, rows)):
        fail("K4/K5 entry points produced non-finite values")
    if k4["binned_plane_scatter"] != 1 or k5["scatter_add_rows_tiled"] != 1:
        fail(f"entry points: K4 launched {k4['binned_plane_scatter']}, K5 "
             f"{k5['scatter_add_rows_tiled']} times, expected 1 each")
    return {"entry_points": {
        "sample_plane_binned": {"shape": [H, W, 64, int(u.shape[0])],
                                "launches": k4},
        "scatter_add_rows_tiled": {"shape": [524288, 90000, 64],
                                   "launches": k5}}}, {
        "binned_plane_scatter": k4["binned_plane_scatter"],
        "scatter_add_rows_tiled": k5["scatter_add_rows_tiled"]}


# ------------------------------------------- small step: card vs the CPU
def check_small_step():
    """One train step of a tiny field on the card (kernels) and on the CPU
    (plain versions) from the same state and rays, in three
    configurations: the dense path under the blur; the blur with in-bbox
    compaction, the dense-grid density and app_k below the gated count;
    and an alpha mask with group compaction and app_k."""
    import copy
    import dataclasses

    import torch

    from joint_tensorf_tpu_torch.data.synthetic import make_scene
    from joint_tensorf_tpu_torch.geometry import lie, poses
    from joint_tensorf_tpu_torch.models import vm as vm_lib
    from joint_tensorf_tpu_torch.models.alpha_mask import AlphaMask
    from joint_tensorf_tpu_torch.render.renderer import BlurSpec
    from joint_tensorf_tpu_torch.train.step import (StepConfig, StepScalars,
                                                    init_train_state,
                                                    train_step)

    cfg = vm_lib.VMConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8),
                          app_dim=9, hidden=16)
    res, V, H, W, R = (24, 24, 24), 3, 24, 24, 64
    scene = make_scene(n_views=V, H=H, W=W, device="cpu")
    gen = torch.Generator().manual_seed(0)
    field = vm_lib.init_vm(cfg, res, [-1.5] * 3 + [1.5] * 3, gen)
    with torch.no_grad():
        for p in list(field.density_planes) + list(field.density_lines):
            p.mul_(8.0)
    noise = torch.randn((V, 6), generator=gen) * 0.05
    pose_base = poses.compose([lie.se3_to_SE3(noise),
                               torch.as_tensor(scene.poses)])
    images = torch.as_tensor(scene.images).reshape(V, 3, -1).transpose(1, 2)
    edges = (torch.rand((V, H * W), generator=gen) > 0.7).float()
    ray_idx = torch.randperm(H * W, generator=gen)[:R]
    view_sel = torch.arange(V)
    mask = AlphaMask(grid=(torch.rand(res, generator=gen) > 0.4).float(),
                     aabb=field.aabb.clone())
    blur = BlurSpec("uniform-gaussian", 8)
    base = StepConfig(H=H, W=W, n_views=V, rays_per_view=R, n_samples=41,
                      blur=blur)
    variants = {
        "dense": (base, None),
        "bbox_compaction_densify_app_k": (dataclasses.replace(
            base, n_samples=64, compact_k=48, densify_density=True,
            app_k=4), None),
        "mask_compaction_app_k": (dataclasses.replace(
            base, n_samples=64, blur=None, mask_stride=2, compact_k=32,
            app_k=4), mask)}
    s = StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3,
                    c2f_density=0.1, c2f_color=0.2, l1_weight=8e-5,
                    use_edge=1.0, edge_factor=1.5, non_edge_factor=0.5)
    jitter = torch.rand((V * R, 1), generator=gen)
    result = {}
    for name, (scfg, am) in variants.items():
        out = {}
        for dev in ("cpu", "cuda"):
            f = copy.deepcopy(field).to(dev)
            st = init_train_state(f, V)
            mv = lambda t: t.to(dev)  # noqa: E731
            metrics, grads = train_step(
                st, scfg, cfg, mv(pose_base),
                mv(torch.as_tensor(scene.intr_inv)), mv(images.contiguous()),
                mv(edges), mv(view_sel), mv(ray_idx), s, jitter=mv(jitter),
                alpha_mask=None if am is None else AlphaMask(
                    grid=mv(am.grid), aabb=mv(am.aabb)), stats=True)
            out[dev] = (float(metrics["loss"]),
                        {k: g.detach().cpu() for k, g in grads.items()},
                        float(metrics["kept_frac"]))
        loss_c, g_c, kept = out["cpu"]
        loss_g, g_g, _ = out["cuda"]
        if not math.isfinite(loss_g) or \
                abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
            fail(f"small step ({name}): card loss {loss_g} vs CPU {loss_c}")
        worst = 0.0
        for k in g_c:
            scale = float(g_c[k].abs().max()) + 1e-12
            worst = max(worst, float((g_g[k] - g_c[k]).abs().max()) / scale)
        if worst > 1e-3:
            fail(f"small step ({name}): card gradients differ from the "
                 f"CPU's by {worst:.3g} of their max")
        result[name] = {"loss_cuda": loss_g, "loss_cpu": loss_c,
                        "max_grad_err_rel": worst, "kept_frac": kept,
                        "step_config": {k: getattr(scfg, k) for k in (
                            "n_samples", "compact_k", "densify_density",
                            "app_k")}}
    return {"small_step": result}


# --------------------------------------------------------------- main path
def run_main_path(n_steps: int, profile_dir=None):
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    opt = set_options(os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
                      ["--data.dataset=synthetic"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = load_dataset(opt, "train", device="cuda")
    t_scene = time.perf_counter() - t0
    trainer = Trainer(opt, data, device="cuda")
    torch.cuda.synchronize()

    stamps, losses = [], []
    expected = {name: 0 for name in cuda_build.LAUNCHES}
    configs = set()

    def on_step(tr, m):
        if m is None:
            return
        configs.add(step_config_summary(tr.last_step_config))
        for name, n in expected_launches(tr.last_step_config).items():
            expected[name] += n

    def on_log(tr, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    cuda_build.reset_launches()
    stamps.append(time.perf_counter())
    trainer.run(max_iter=n_steps, log_every=1, callback=on_log,
                on_step=on_step)
    launches = dict(cuda_build.LAUNCHES)
    steps = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses):
        fail(f"main path: losses {losses}")
    # K4 and K5 lie on no trainer path: 0 launches
    if launches != expected:
        fail(f"main path: launched {launches} in {n_steps} steps, expected "
             f"{expected}")
    if not all(c["densify_density"] for c in map(dict, configs)):
        fail(f"main path: the first phase did not use the dense grid: "
             f"{configs}")
    result = {
        "main_path": {
            "config": "configs/bat_blender_VM.yaml --data.dataset=synthetic",
            "image_hw": [trainer.H, trainer.W], "views": trainer.n_views,
            "resolution": trainer.resolution, "n_samples": trainer.n_samples,
            "rays_per_step": trainer.rays_per_step,
            "step_configs": [dict(c) for c in configs],
            "budgets": budgets(trainer),
            "steps": n_steps, "loss": losses,
            "step_ms_first": steps[0] * 1e3,
            "step_ms_median": statistics.median(steps[1:]) * 1e3,
            "step_ms_all": [x * 1e3 for x in steps],
            "launches": launches,
            "launches_per_step": {k: v / n_steps for k, v in launches.items()},
            "scene_render_s": t_scene,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}
    if profile_dir:
        result["profile"] = profile_steps(
            trainer, n_steps + 3,
            os.path.join(profile_dir, "step_profile.txt"))
    return result, launches, (trainer.rays_per_step, trainer.last_step_config,
                              list(trainer.resolution))


def step_config_summary(cfg):
    """The step's tpu: choices, hashable."""
    return tuple((k, getattr(cfg, k)) for k in (
        "n_samples", "compact_k", "densify_density", "app_k"))


def budgets(trainer) -> dict:
    return {k: getattr(trainer, k) for k in (
        "compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")}


def warm_start_density(trainer, seed: int):
    """Raise one density component per blob of the synthetic scene by
    WARM_DENSITY over a box of +-WARM_RADII radii around the blob's centre
    (component k of every plane over the box's two axes, of every line over
    its third): the density feature there clears the alpha threshold,
    elsewhere it stays at its fresh value, so the first mask update has
    objects to keep, and rays cross empty space between them.  Its masked
    phases are sparser than a trained Blender field's, so the gaps between
    the paths hold for this field only.  Returns the boxes."""
    import numpy as np
    import torch

    from joint_tensorf_tpu_torch.data.synthetic import BlobField
    from joint_tensorf_tpu_torch.models.vm import MAT_MODE, VEC_MODE

    blobs = BlobField(seed=seed)
    field = trainer.state.field
    aabb = field.aabb.cpu().numpy()
    res = field.resolution()
    axes = [np.linspace(aabb[0, a], aabb[1, a], res[a]) for a in range(3)]
    boxes = []
    with torch.no_grad():
        for k, (c, r) in enumerate(zip(blobs.centers, blobs.radii)):
            lo, hi = c - WARM_RADII * r, c + WARM_RADII * r
            inside = [torch.as_tensor((x >= lo[a]) & (x <= hi[a]),
                                      dtype=torch.float32,
                                      device=field.aabb.device)
                      for a, x in enumerate(axes)]
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                field.density_planes[i][..., k].add_(
                    WARM_DENSITY * inside[m1][:, None] * inside[m0][None, :])
                field.density_lines[i][:, k].add_(
                    WARM_DENSITY * inside[VEC_MODE[i]])
            boxes.append([lo.tolist(), hi.tolist()])
    return boxes


def run_all_phases(label: str, extra_args=(), profile_dir=None):
    """BAT at full width through every phase of a schedule cut to 40
    iterations (PHASES_ARGS + extra_args).  Trainer.run's on_step hook
    reads the host clock between synchronised points after each step and
    after each schedule update, so each step and each transition is timed
    on its own, and the launch counters are read after every step and held
    against expected_launches of the step's configuration.  With
    profile_dir, two blurred steps at the last resolution (the dense grid
    of 64M voxels) and the last 3 steps run under torch.profiler and are
    left out of the step times.  Prints one line per phase; returns the
    last step's shape: (rays, samples per ray as composited, resolution,
    the step's configuration, and (samples per ray kept, resolution) of
    the last blurred dense-grid step at the last resolution, or None)."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    opt = set_options(os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
                      PHASES_ARGS + list(extra_args))
    default_path = not extra_args
    data = load_dataset(opt, "train", device="cuda")
    trainer = Trainer(opt, data, device="cuda")
    support = warm_start_density(trainer, int(opt.data.get("seed", 0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ups = list(opt.train_schedule.upsample_iters)
    masks = list(opt.train_schedule.update_alphamask_iters)

    def state():
        mask = trainer.alpha_mask
        return {"resolution": list(trainer.resolution),
                "n_samples": trainer.n_samples,
                "aabb": trainer.state.field.aabb.cpu().numpy().tolist(),
                "mask_res": (list(trainer.alphamask_resolution)
                             if mask is not None else None),
                "mask_kept": (float(mask.grid.mean())
                              if mask is not None else None),
                **budgets(trainer)}

    steps, transitions = [], []
    clock = {"t": time.perf_counter(), "launches": dict(cuda_build.LAUNCHES)}

    def on_step(tr, m):
        """After each step (m: its metrics) and after each schedule update
        (m None): synchronise, then time the step or the transition alone
        and count the step's launches."""
        torch.cuda.synchronize()
        now, launches = time.perf_counter(), dict(cuda_build.LAUNCHES)
        ms = (now - clock["t"]) * 1e3
        if m is not None:
            before = state()
            cfg = tr.last_step_config
            steps.append({
                "it": tr.it, "step_ms": ms, "blur": bool(m["blur"]),
                **{k: before[k] for k in ("resolution", "n_samples",
                                          "mask_res")},
                **{k: float(m[k]) for k in ("loss", "valid_frac",
                                            "inbbox_frac", "kept_frac")},
                "config": dict(step_config_summary(cfg)),
                "budgets": budgets(tr),
                "launches": {k: launches[k] - clock["launches"][k]
                             for k in launches},
                "expected": expected_launches(cfg)})
        elif tr.it in ups or tr.it in masks:
            after = state()
            transitions.append({
                "after_it": tr.it, "ms": ms, **after,
                "peak_mem_gb_before": torch.cuda.max_memory_allocated() / 1e9})
            print(f"[phase {label}] after it {tr.it}: {json.dumps(after)} "
                  f"({ms:.1f} ms)", flush=True)
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        clock["t"], clock["launches"] = time.perf_counter(), launches

    n_iter = int(opt.max_iter)
    n_timed = n_iter - 3 if profile_dir else n_iter
    # with profile_dir, two blurred steps at the last resolution (after
    # the last upsample and its first step) run under torch.profiler too
    blur_window = (ups[-1] + 2, ups[-1] + 4) if profile_dir else None
    profiled = set(range(n_timed, n_iter))
    t_run = time.perf_counter()
    prof, prof_blur = None, None
    if profile_dir:
        trainer.run(max_iter=blur_window[0], log_every=1, on_step=on_step,
                    stats=True)
        prof_blur = profile_steps(trainer, blur_window[1], os.path.join(
            profile_dir, f"all_phases_{label}_blurred_steps_profile.txt"),
            on_step)
        profiled.update(range(*blur_window))
        clock["t"] = time.perf_counter()
    trainer.run(max_iter=n_timed, log_every=1, on_step=on_step, stats=True)
    t_run = time.perf_counter() - t_run
    if profile_dir:
        prof = profile_steps(trainer, n_iter, os.path.join(
            profile_dir, f"all_phases_{label}_last_steps_profile.txt"),
            on_step)
    peak_last = torch.cuda.max_memory_allocated() / 1e9

    # ---------------- checks (collected; raised after the result is out)
    faults = []
    if len(steps) != n_iter or not all(math.isfinite(r["loss"])
                                       for r in steps):
        faults.append(f"losses {[r.get('loss') for r in steps]}")
    faults += [f"step {r['it']} launched {r['launches']}, expected "
               f"{r['expected']}" for r in steps
               if r["launches"] != r["expected"]]
    by_it = {t["after_it"]: t for t in transitions}
    res_prev = steps[0]["resolution"]
    for it in sorted(by_it):
        t = by_it[it]
        if it in ups and math.prod(t["resolution"]) <= math.prod(res_prev):
            faults.append(f"the upsample after it {it} did not grow the "
                          f"grid ({res_prev} -> {t['resolution']})")
        res_prev = t["resolution"]
    first, second = by_it[masks[0]], by_it[masks[1]]
    if not 0 < first["mask_kept"] < 1 or first["aabb"] == [[-1.5] * 3,
                                                           [1.5] * 3]:
        faults.append(f"the first mask update kept nothing or did not "
                      f"shrink the box: {first}")
    if first["mask_res"] != steps[masks[0]]["resolution"]:
        faults.append(f"the first mask update was capped: {first}")
    if math.prod(second["mask_res"]) >= math.prod(second["resolution"]):
        faults.append(f"the second mask update was not capped: {second}")
    gated = [r for r in steps if r["mask_res"] and not r["blur"]]
    if not gated or not any(0 < r["valid_frac"] < r["inbbox_frac"]
                            for r in gated):
        faults.append("the mask culled no sample (or every sample) once "
                      "the blur was off")
    last = [r for r in gated if r["resolution"] == steps[-1]["resolution"]]
    # the dense grid under the blur at the last resolution (64M voxels)
    blurred_last = [r for r in steps if r["blur"]
                    and r["config"]["densify_density"]
                    and r["resolution"] == steps[-1]["resolution"]]
    if blur_window and not set(range(*blur_window)) <= {
            r["it"] for r in blurred_last}:
        faults.append(f"the profiled steps {list(range(*blur_window))} "
                      f"were not all blurred dense-grid steps at the last "
                      f"resolution")
    if default_path:
        if not any((r["config"]["compact_k"] or r["n_samples"])
                   < r["n_samples"] for r in last):
            faults.append("no step of the masked last phase compacted "
                          "(compact_k < S)")
        if not blurred_last:
            faults.append("no step under the blur used the dense grid at "
                          "the last resolution")
    elif any(r["config"]["densify_density"] or r["config"]["app_k"]
             or r["budgets"]["compact_k_blur"] is not None
             or (r["config"]["compact_k"] and (r["blur"] or not r["mask_res"]))
             for r in steps):
        # the alpha mask's own budget stays: the JAX trainer has no switch
        # for it (joint_tensorf_tpu/train/trainer.py:874)
        faults.append("a tpu: alternative ran with the alternatives off")

    # ---------------- per-phase step times
    phases = []
    for r in steps:
        if r["it"] in profiled:
            continue
        key = (r["resolution"], r["n_samples"], r["mask_res"], r["blur"],
               r["config"]["compact_k"], r["config"]["densify_density"],
               r["config"]["app_k"])
        if not phases or phases[-1]["key"] != key:
            phases.append({"key": key, "its": [], "ms": [], "kept": [],
                           "valid": [], "launches": r["launches"],
                           "budgets": r["budgets"]})
        phases[-1]["its"].append(r["it"])
        phases[-1]["ms"].append(r["step_ms"])
        phases[-1]["kept"].append(r["kept_frac"])
        phases[-1]["valid"].append(r["valid_frac"])
    rows = []
    for p in phases:
        k = p["key"]
        row = {"resolution": k[0], "n_samples": k[1], "mask_res": k[2],
               "blur": k[3], "compact_k": k[4], "densified": k[5],
               "app_k": k[6], "budgets": p["budgets"],
               "iterations": [p["its"][0], p["its"][-1]],
               "kept_frac": statistics.mean(p["kept"]),
               "valid_frac": statistics.mean(p["valid"]),
               "launches_per_step": {n: c for n, c in p["launches"].items()
                                     if n in ("composite_fwd",
                                              "composite_bwd",
                                              "scatter_add_rows")},
               "step_ms_median": statistics.median(p["ms"]),
               "step_ms": p["ms"]}
        rows.append(row)
        print(f"[phase-steps {label}] its {row['iterations']} res {k[0]} "
              f"S {k[1]} blur {k[3]} mask {k[2]} budgets {p['budgets']} "
              f"step: compact_k {k[4]} densified {k[5]} app_k {k[6]} "
              f"kept {row['kept_frac']:.3f} live {row['valid_frac']:.3f} "
              f"launches {row['launches_per_step']} median "
              f"{row['step_ms_median']:.1f} ms", flush=True)
    result = {f"all_phases_{label}": {
        "config": "configs/bat_blender_VM.yaml " + " ".join(
            PHASES_ARGS + list(extra_args)),
        "rays_per_step": trainer.rays_per_step, "run_s": t_run,
        "warm_density": {"add": WARM_DENSITY, "radii": WARM_RADII,
                         "boxes": support},
        "transitions": transitions, "phases": rows,
        "valid_frac_mean_gated": statistics.mean(
            r["valid_frac"] for r in gated) if gated else None,
        "inbbox_frac_mean_gated": statistics.mean(
            r["inbbox_frac"] for r in gated) if gated else None,
        "loss": [r["loss"] for r in steps],
        "peak_mem_gb_last_phase": peak_last,
        "peak_mem_gb": max([peak_last] + [t["peak_mem_gb_before"]
                                          for t in transitions]),
        "profile_blurred_steps": prof_blur,
        "profile_last_steps": prof}}
    emit(result)
    if faults:
        fail(f"all phases ({label}): " + "; ".join(faults))
    cfg = trainer.last_step_config
    blurred = None
    if blurred_last:
        r = blurred_last[-1]
        blurred = (min(r["config"]["compact_k"] or r["n_samples"],
                       r["n_samples"]), r["resolution"])
    return (trainer.rays_per_step,
            min(cfg.compact_k or cfg.n_samples, cfg.n_samples),
            list(trainer.resolution), cfg, blurred)


def profile_steps(trainer, end, table_path, on_step=None):
    """torch.profiler over the steps up to ``end``: device time by kernel,
    written as a table to table_path; returns the device-busy time per step
    and the ported kernels' mean device durations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = end - trainer.it
    os.makedirs(os.path.dirname(table_path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(max_iter=end, log_every=1, on_step=on_step,
                    stats=on_step is not None)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    with open(table_path, "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # K3's narrow route is the dense grid's scatter, its wide route the
    # planes'
    ours = {name: [(e.self_device_time_total, e.count)
                   for e in kernels if name in e.key]
            for name in ("composite_fwd_kernel", "composite_bwd_kernel",
                         "scatter_add_rows_narrow_kernel",
                         "scatter_add_rows_wide_kernel")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {"steps": n, "device_busy_ms_per_step": busy_ms / n,
            "kernel_mean_ms": {
                k: sum(t for t, _ in v) / sum(c for _, c in v) / 1e3
                if v else None for k, v in ours.items()},
            "top_kernels_ms_per_step": [
                (e.key[:90], e.self_device_time_total / 1e3 / n, e.count // n)
                for e in top]}


def check_tiled_all(gen):
    """K5 at the JAX bench scripts' shapes, then with every sample in one
    row and with int32 indices."""
    rows = [check_tiled(N, n_rows, C, gen, 1e-5) for N, n_rows, C in (
        (524288, 90000, 64), (524288, 160000, 64), (131072, 160000, 192))]
    return rows + [check_tiled(524288, 90000, 64, gen, 1e-5, case=case)
                   for case in ("one_row", "int32")]


def main(argv):
    if argv and (len(argv) != 2 or argv[0] != "--profile"):
        fail(f"usage: python3 chip_smoke.py [--profile DIR], got {argv}")
    profile_dir = argv[1] if argv else None

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "joint_tensorf_tpu_torch")):
        print("chip_smoke: the joint_tensorf_tpu_torch package is not next "
              "to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.utils import setup_torch

    setup_torch()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi printed nothing", flush=True)
    emit({"nvidia_smi": smi[0] if smi else None,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    took = cuda_build.build_all()
    emit({"build": took, "seconds": time.perf_counter() - t0})

    gen = torch.Generator(device="cuda").manual_seed(0)
    for r in check_composite(2028, 221, 1e-6, gen, tol=1e-4):
        emit({"kernel_check": r})
    emit({"kernel_check": check_scatter(2028, 221, 64, 64, 256, gen,
                                        tol=1e-5)})
    emit({"kernel_check": check_scatter(2028, 221, 400, 400, 256, gen,
                                        tol=1e-5)})
    binned = [check_binned(400, 400, 64, 2028 * 1000, gen, 1e-5, "march")]
    for H, W, R, N in ((300, 300, 64, 2000000), (300, 300, 64, 524288),
                       (128, 128, 64, 886000)):
        binned.append(check_binned(H, W, R, N, gen, 1e-5))
    binned.append(check_binned(257, 257, 64, 2028 * 1000, gen, 0.0,
                               "one_cell"))
    for r in binned:
        emit({"kernel_check": r})
    tiled = check_tiled_all(gen)
    for r in tiled:
        emit({"kernel_check": r})
    torch.cuda.empty_cache()
    emit(check_small_step())
    entry, entry_launches = run_entry_points(gen)
    emit(entry)

    result, launches, (n_rays, cfg, res) = run_main_path(N_STEPS,
                                                         profile_dir)
    emit(result)
    main_cfg = cfg
    # K1/K2 and K3 at the main path's own shapes: the samples each ray
    # composites; the dense grid's row gather and the appearance planes'
    # gradient (4 x 48 packed channels) on the app_k samples of each ray
    S = min(cfg.compact_k or cfg.n_samples, cfg.n_samples)
    rows = check_composite(n_rays, S, 1e-6, gen, tol=1e-4)
    for r in rows:
        emit({"kernel_check": r})
    dense_rows = check_scatter(n_rays, S, 0, 0, 8, gen, tol=1e-5,
                               grid3d=tuple(res))
    emit({"kernel_check": dense_rows})
    scatter = check_scatter(n_rays, min(cfg.app_k, S), res[1], res[0], 192,
                            gen, tol=1e-5)
    emit({"kernel_check": scatter})
    torch.cuda.empty_cache()
    n_rays, S, res, cfg, (S_blur, res_blur) = run_all_phases(
        "tpu_default", (), profile_dir)
    torch.cuda.empty_cache()
    # K3 on the dense grid of the blurred phase at the last resolution (64M
    # voxels at this schedule): the samples each ray kept there
    emit({"kernel_check": check_scatter(n_rays, S_blur, 0, 0, 8, gen,
                                        tol=1e-5, grid3d=tuple(res_blur))})
    torch.cuda.empty_cache()
    # K1-K3 again at the shapes the default path's last phase gave them: the
    # compacted samples of each ray, and K3 into the largest of the three
    # planes (density planes: 4 x 16 packed channels on every kept sample;
    # appearance: 4 x 48 on app_k of them)
    from joint_tensorf_tpu_torch.models.vm import MAT_MODE

    Hp, Wp = max(((res[m1], res[m0]) for m0, m1 in MAT_MODE),
                 key=lambda hw: hw[0] * hw[1])
    for r in check_composite(n_rays, S, 1e-6, gen, tol=1e-4):
        emit({"kernel_check": r})
    emit({"kernel_check": check_scatter(n_rays, S, Hp, Wp, 64, gen,
                                        tol=1e-5)})
    emit({"kernel_check": check_scatter(n_rays, min(cfg.app_k or S, S), Hp,
                                        Wp, 192, gen, tol=1e-5)})
    torch.cuda.empty_cache()
    # the alternatives off, at the same cut schedule: every slot of S =
    # 1000 composited, K3 on the fused planes' 4 x 64 channels
    n_rays, S, res, _, _ = run_all_phases("alternatives_off",
                                          ALTERNATIVES_OFF)
    torch.cuda.empty_cache()
    for r in check_composite(n_rays, S, 1e-6, gen, tol=1e-4):
        emit({"kernel_check": r})
    emit({"kernel_check": check_scatter(n_rays, S, Hp, Wp, 256, gen,
                                        tol=1e-5)})
    launches.update(entry_launches)
    kernels = []
    # K1 and K2 as the main path's step calls them: K2 with g_weights when
    # the two-stage appearance gathers the selected weights
    main_k2 = rows[2] if main_cfg.app_k is not None else rows[1]
    for r in [rows[0], main_k2, scatter, binned[0], tiled[0]]:
        k = {key: r[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        k["launches"] = launches[r["name"]]
        kernels.append(k)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
