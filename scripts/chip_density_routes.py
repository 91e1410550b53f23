#!/usr/bin/env python
"""The VM density feature's two routes, timed on one NVIDIA GPU at the
shapes of BAT's LLFF and Blender schedules: the dense grid
(vm.sample_density_grid: the rank expansion, pack_corners, the row gather
and K3 into its rows) against the summed factor sample
(vm.compute_density_feature with the live mask: K6 forward and backward).

    python3 scripts/chip_density_routes.py [LABEL ...]

Prints the card's name and power limit (nvidia-smi), then one JSON line a
shape: for each route the forward and the forward + backward ms (CUDA
events, the median of 5 calls after 2), the device ms of one forward +
backward from torch.profiler (the sum of its kernels and memsets), the
peak memory and each output's largest error against the plain factored
sample in float64 (over that output's largest entry); the two routes'
largest difference.
The last line lists the faster route at each shape, with its voxels a
sample: the crossover PERF.md records for the renderer's choice
(render/renderer.py density_route, which builds the grid only where K6
does not apply).

Coordinates are made from a seed: NDC rays (LLFF) keep x and y within
+-0.05 of a start and sweep z over the box, as a forward-facing ray's
samples do; Euclidean rays (Blender) march through a point of the box (at
their middle sample) in a random direction by half a voxel a sample, live
while inside the box.
Factors are drawn as init_vm draws them (scale 0.05, bias 0.2 as LLFF's).
"""
import json
import math
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (label, resolution [X, Y, Z], density ranks, rays, samples a ray, NDC)
SHAPES = [
    ("llff_50^3_first", (50, 50, 50), 16, 20480, 1000, True),
    ("llff_100^3", (100, 100, 100), 16, 4420, 1000, True),
    ("llff_200^3", (193, 215, 193), 16, 4420, 1000, True),
    ("llff_400^3", (386, 430, 386), 16, 4420, 1000, True),
    ("llff_final", (771, 859, 771), 16, 4420, 1000, True),
    ("blender_64^3_first", (64, 64, 64), 16, 2048, 221, False),
    ("blender_101^3", (101, 101, 101), 16, 2048, 349, False),
    ("blender_160^3_blurred", (160, 160, 160), 16, 2048, 554, False),
    ("blender_253^3", (253, 253, 253), 16, 2048, 876, False),
    ("blender_400^3", (400, 400, 400), 16, 2048, 1000, False),
    # a smaller grid, where the samples crowd the factors' rows, and wider
    # density ranks, where the factored sample reads more a sample
    ("llff_16^3", (16, 16, 16), 16, 20480, 1000, True),
    ("llff_50^3_r32", (50, 50, 50), 32, 20480, 1000, True),
    ("blender_64^3_r32", (64, 64, 64), 32, 2048, 221, False),
    ("blender_101^3_r32", (101, 101, 101), 32, 2048, 349, False),
    ("llff_50^3_r48", (50, 50, 50), 48, 20480, 1000, True),
    ("llff_100^3_r48", (100, 100, 100), 48, 4420, 1000, True),
    ("blender_64^3_r48", (64, 64, 64), 48, 2048, 221, False),
    ("blender_160^3_r48", (160, 160, 160), 48, 2048, 554, False),
]


def coords_for(res, rays, S, ndc, gen, dev="cuda"):
    import torch

    if ndc:
        start = torch.rand((rays, 1, 2), generator=gen, device=dev) * 1.8 - 0.9
        drift = (torch.rand((rays, 1, 2), generator=gen, device=dev) - 0.5) \
            * 0.1
        t = (torch.arange(S, device=dev)[None, :, None]
             + torch.rand((rays, S, 1), generator=gen, device=dev)) / S
        xy = start + drift * t
        z = -0.3 + t * 1.29                  # off the faces
        pts = torch.cat([xy, z], dim=-1)
    else:
        start = torch.rand((rays, 1, 3), generator=gen, device=dev) * 2 - 1
        d = torch.randn((rays, 1, 3), generator=gen, device=dev)
        d = d / d.norm(dim=-1, keepdim=True)
        step = 1.0 / (max(res) - 1)          # half a voxel of [-1, 1]
        t = torch.arange(S, device=dev)[None, :, None] - S / 2
        pts = start + t * step * d
    live = (pts.abs() <= 1).all(dim=-1).reshape(-1)
    return [pts[..., a].reshape(-1).contiguous() for a in range(3)], live


def make_routes(res, rank, rays, S, ndc, dev="cuda"):
    """(routes {name: forward}, the leaves and coordinates they take
    gradients for, the cotangent, the live mask) at one shape."""
    import torch

    from joint_tensorf_tpu_torch.models import vm
    from joint_tensorf_tpu_torch.ops import sampling

    gen = torch.Generator(device=dev).manual_seed(25)
    cfg = vm.VMConfig(density_n_comp=(rank,) * 3, app_n_comp=(4,) * 3,
                      app_dim=4, hidden=8)
    field = vm.init_vm(cfg, list(res), torch.tensor([[-1.0] * 3, [1.0] * 3]),
                       gen, init_scale=0.05, init_bias=0.2, device=dev)
    coords, live = coords_for(res, rays, S, ndc, gen, dev)
    cot = torch.randn(coords[0].shape, generator=gen, device=dev)
    xs = [c.detach().requires_grad_(True) for c in coords]
    routes = {
        # the renderer zeroes the dead slots' density after either route
        "grid": lambda: torch.where(live, vm.sample_density_grid(
            field, cfg, xs), 0.0),
        "factored": lambda: vm.compute_density_feature(field, cfg, xs,
                                                       live=live),
    }
    leaves = list(field.density_planes) + list(field.density_lines)

    def exact():
        """The plain factored sample in float64: the feature and the
        gradients of the leaves and coordinates."""
        wrt = [t.detach().double().requires_grad_(True) for t in leaves + xs]
        val = sampling.sample_planeline_prod_sum_plain(
            wrt[0:3], wrt[3:6], wrt[6:9], vm.AXES, live)
        return [val.detach(), *torch.autograd.grad(
            (val * cot.double()).sum(), wrt)]

    return routes, leaves + xs, cot, live, exact


def run_shape(label, res, rank, rays, S, ndc):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    routes, wrt, cot, live, exact = make_routes(res, rank, rays, S, ndc)
    out = {"label": label, "resolution": list(res), "voxels": math.prod(res),
           "rank": rank, "rays": rays, "S": S, "samples": rays * S,
           "live_share": float(live.float().mean()), "ndc": ndc}
    values = {}
    for name, fwd in routes.items():
        def both():
            val = fwd()
            return val, torch.autograd.grad((val * cot).sum(), wrt)

        def timed(fn, n=5, warm=2):
            for _ in range(warm):
                fn()
            ms = []
            for _ in range(n):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            return statistics.median(ms)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd_ms = timed(fwd)
        step_ms = timed(both)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            both()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        top = sorted(((e.self_device_time_total, e.key[:60])
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)[:4]
        val, grads = both()
        values[name] = [val.detach(), *grads]
        out[name] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": step_ms,
                     "device_ms": dev_us / 1e3, "peak_gb": peak / 1e9,
                     "top_device_ms": [[k, round(t / 1e3, 4)]
                                       for t, k in top]}
    # the float64 reference where it fits beside the routes' tensors
    ref = exact() if rays * S * rank <= 700_000_000 else None
    names = ["feature"] + [f"plane{i}" for i in range(3)] + [
        f"line{i}" for i in range(3)] + ["x", "y", "z"]
    for name, got in values.items() if ref is not None else ():
        # each output's largest error over its largest reference entry
        out[name]["rel_err_vs_f64"] = {
            n: float((a.double() - b).abs().max())
            / max(float(b.abs().max()), 1e-30)
            for n, a, b in zip(names, got, ref)}
    del ref
    out["max_rel_diff"] = max(
        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        for a, b in zip(values["factored"], values["grid"]))
    out["faster"] = min(("grid", "factored"),
                        key=lambda r: out[r]["device_ms"])
    print(json.dumps(out), flush=True)
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_density_routes: no CUDA device")
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.utils import setup_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi printed nothing",
          flush=True)
    setup_torch()
    cuda_build.build_all(["segment_scatter", "density_sample"])
    rows = [run_shape(*s) for s in SHAPES if not argv or s[0] in argv]
    print(json.dumps({"faster": [
        {"label": r["label"], "voxels_per_sample": r["voxels"] / r["samples"],
         "faster": r["faster"]} for r in rows]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
