#!/usr/bin/env python
"""Variants of kernels K3, K1 and K4 on one NVIDIA GPU: the measurements
behind the designs of joint_tensorf_tpu_torch/csrc/segment_scatter.cu,
csrc/composite.cu and csrc/binned_scatter.cu.

    python3 scripts/chip_kernel_variants.py [--k3] [OUT_DIR]

K3's variants (streaming loads on the narrow route, cached loads on the
wide route, scalar atomics, one atomic per row on the narrow route, 64
rows a group and 4 rows in flight on the wide route) run
at chip_smoke.py's K3 shapes, rows in march order; --k3 runs only those.

Each variant is the checked-in source with one edit (a constant, a loop
bound, a branch), built with nvcc (-Xptxas -v) into OUT_DIR (default
joint_tensorf_tpu_torch/_build/variants) and loaded in place of the package's library.  K1's
variants (threads per ray x samples per thread) run at N = 2028 rays of
S = 221 and S = 1000 samples; K4's at 400^2 x 64 with 2.03M samples in march
order and at 300^2 x 64 with 2M uniform samples.  Prints one JSON line
per variant: device times from torch.profiler (back to back; K4: the
accumulate kernel on a prebuilt bucketing, and the whole route), the
registers and spills nvcc reports for the kernel, and the largest
difference from the plain version.  The
ablations (no_flush, no_class_passes, plain_edge_writes) drop or break
work on purpose: their results are wrong and only their times count.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

K1_SHAPE = ("constexpr int kFwdRayThreads = 64;",
            "  if (S <= 768) return (int)launch_fwd<4>(A, s);\n"
            "  return (int)launch_fwd<8>(A, s);")
K4_EDITS = {
    "flush": ("  // flush: interior pixels of a one-chunk tile are this block's "
              "alone\n"),
    "classes": "  for (int cls = 0; cls < 4; ++cls) {",
    "atomic": ("    if (atomic)\n      vatomic(q[c], s[c]);\n    else\n"
               "      vaccum(q[c], s[c]);"),
    "slice": ("const int per = max((n_c + n_workers - 1) / n_workers, "
              "kUnroll);"),
    "unroll": "constexpr int kUnroll = 4;",
    "bounds": "__launch_bounds__(kAccThreads, 4)",
    "put": "put_cell(acc, R, cur, e, sum, first_cell);",
    "k_lo": "const int k_lo = cls * kClass;",
    "n_c": "n_c = kstart[k_lo + kClass] - ca;",
    "lo_hi": "int lo = k_lo, hi = k_lo + kClass - 1;",
    "helpers": "// Add one cell's four corner sums",
    "dispatch": "  if (R % 4 == 0 && ((uintptr_t)g & 15) == 0)\n",
}
FLOAT2 = """// float2 helpers (variant)
__device__ __forceinline__ float2 vzero(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ void vfma(float2& a, float2 x, float w) {
  a.x = fmaf(x.x, w, a.x);
  a.y = fmaf(x.y, w, a.y);
}
__device__ __forceinline__ void vaccum(float* p, float2 v) {
  float2* q = reinterpret_cast<float2*>(p);
  float2 a = *q;
  a.x += v.x;
  a.y += v.y;
  *q = a;
}
__device__ __forceinline__ void vatomic(float* p, float2 v) {
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
}
__device__ __forceinline__ void vstore(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void vatomic_nonzero(float* p, float2 v) {
  vatomic_nonzero(p, v.x);
  vatomic_nonzero(p + 1, v.y);
}
"""


def edit(src, *pairs):
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def k4_variants(base):
    e = K4_EDITS
    one_pass = (
        (e["classes"], "  for (int cls = 0; cls < 1; ++cls) {"),
        (e["k_lo"], "const int k_lo = 0;"),
        (e["n_c"], "n_c = kstart[kCells] - ca;"),
        (e["lo_hi"], "int lo = 0, hi = kCells - 1;"),
        (e["put"], "put_cell(acc, R, cur, e, sum, true);"))
    float2 = (
        (e["helpers"], FLOAT2 + e["helpers"]),
        (e["dispatch"], "  if (R % 2 == 0 && R <= 64)\n"
         "    return (int)launch_accumulate<float2>(\n"
         "        (const float*)g, (const float*)fx, (const float*)fy, L,\n"
         "        (float*)out, H, W, R, n_tx, CH, n_map, s);\n"
         + e["dispatch"]))
    return {
        "checked_in": (base, True),
        "no_flush": (edit(base, (e["flush"], "  return;\n" + e["flush"])),
                     False),
        "no_class_passes": (edit(base, (e["classes"],
                                        "  for (int cls = 0; cls < 0; ++cls) {")),
                            False),
        "plain_edge_writes": (edit(base, (e["atomic"],
                                          "    vaccum(q[c], s[c]);")), False),
        "min_slice_32": (edit(base, (e["slice"], e["slice"].replace(
            "kUnroll);", "32);"))), True),
        "one_pass_all_atomic": (edit(base, *one_pass), True),
        "unroll_2": (edit(base, (e["unroll"], "constexpr int kUnroll = 2;")),
                     True),
        "unroll_8_3_blocks": (edit(base, (e["unroll"],
                                          "constexpr int kUnroll = 8;"),
                                   (e["bounds"],
                                    "__launch_bounds__(kAccThreads, 3)")),
                              True),
        "float2_lanes": (edit(base, *float2), True),
    }


K3_EDITS = {
    "narrow_load": "v[k] = __ldg(upd + r * NV + k);",
    "wide_load": "__ldcs(src + (long long)(s + u) * E + e)",
    "vec_atomic": "  atomicAdd(reinterpret_cast<float4*>(p), v);",
    "depth": "const unsigned depth = __reduce_max_sync(kFull, (unsigned)(lane - head));",
    "tail": "const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);",
    "rows": "constexpr int kRowsPerGroup = 32;",
    "unroll": "constexpr int kUnroll = 8;",
}
# K3's shapes: chip_smoke.py's (rays, samples a ray, plane (H, W) or dense
# grid (X, Y, Z), C), rows in march order
K3_SHAPES = (
    (2028, 221, (64, 64, 64), 8), (2028, 1000, (423, 359, 420), 8),
    (2028, 64, (64, 64), 192), (2028, 512, (420, 423), 64),
    (2028, 128, (420, 423), 192), (2028, 640, (420, 423), 256))


def k3_variants(base):
    e = K3_EDITS
    return {
        "checked_in": base,
        "narrow_streaming_loads": edit(base, (e["narrow_load"], e[
            "narrow_load"].replace("__ldg", "__ldcs"))),
        "wide_cached_loads": edit(base, (e["wide_load"], e[
            "wide_load"].replace("__ldcs", "__ldg"))),
        "scalar_atomics": edit(base, (e["vec_atomic"], (
            "  atomicAdd(p, v.x);\n  atomicAdd(p + 1, v.y);\n"
            "  atomicAdd(p + 2, v.z);\n  atomicAdd(p + 3, v.w);"))),
        "narrow_atomic_per_row": edit(
            base, (e["depth"], "const unsigned depth = 0;"),
            (e["tail"], "const bool tail = true;")),
        "rows_per_group_64": edit(base, (e["rows"], e["rows"].replace(
            "32", "64"))),
        "unroll_4": edit(base, (e["unroll"], e["unroll"].replace("8", "4"))),
    }


def run_k3(out_dir, gen):
    """K3's variants at K3_SHAPES: the kernel's device time (the output's
    memset left out) and the largest difference from index_add_."""
    import torch

    import chip_smoke as cs
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.ops import segment_scatter as K

    cases = []
    for n_rays, S, dest, C in K3_SHAPES:
        if len(dest) == 3:
            idx = cs.march_indices_3d(n_rays, S, *dest, gen)
        else:
            idx = cs.march_indices(n_rays, S, *dest, gen)
        n_rows = 1
        for d in dest:
            n_rows *= d
        upd = torch.randn((idx.shape[0], C), generator=gen, device="cuda")
        cases.append((f"{idx.shape[0]} x {C} -> {dest}", idx, upd, n_rows))
    src = open(os.path.join(cuda_build.CSRC, "segment_scatter.cu")).read()
    for name, vsrc in k3_variants(src).items():
        lib, log = build(out_dir, "k3_" + name, "segment_scatter", vsrc)
        fn = lib.scatter_add_rows
        fn.argtypes, fn.restype = K._ARGTYPES, ctypes.c_int
        cuda_build._FNS["scatter_add_rows"] = fn
        row = {"variant": "K3 " + name,
               "ptxas": ptxas(log, "scatter_add_rows_narrow_kernel")
               + ptxas(log, "scatter_add_rows_wide_kernel")}
        for label, idx, upd, n_rows in cases:
            got = K.scatter_add_rows_cuda(idx, upd, n_rows)
            want = K.scatter_add_rows_plain(idx, upd, n_rows)
            row[label] = {
                "kernel_device_ms": cs.device_ms(
                    lambda: K.scatter_add_rows_cuda(idx, upd, n_rows),
                    "scatter_add_rows_"),
                "max_abs_err": float((got - want).abs().max()),
                "max_abs_out": float(want.abs().max())}
            del got, want
        print(json.dumps(row), flush=True)
    cuda_build._FNS.pop("scatter_add_rows")


def build(out_dir, name, stem, src):
    from joint_tensorf_tpu_torch.ops import cuda_build

    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, stem + ".cu"), "w") as f:
        f.write(src)
    for h in cuda_build.HEADERS:
        shutil.copy(os.path.join(cuda_build.CSRC, h), d)
    lib = os.path.join(d, f"lib{stem}.so")
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                        "-Xptxas", "-v", "-o", lib,
                        os.path.join(d, stem + ".cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(lib), r.stdout + r.stderr


def ptxas(log, kernel):
    """[(instantiation, registers, spill stores)] of one kernel."""
    return [(m.group(1), int(m.group(3)), int(m.group(2))) for m in re.finditer(
        kernel + r"(\w*)E.*?\n.*?(\d+) bytes spill stores.*?\n.*?Used (\d+) "
        r"registers", log)]


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_variants: no CUDA device")
    import chip_smoke as cs
    from joint_tensorf_tpu_torch.ops import binned_scatter as K4
    from joint_tensorf_tpu_torch.ops import composite as C
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.utils import setup_torch

    only_k3 = argv[:1] == ["--k3"]
    argv = argv[1:] if only_k3 else argv
    out_dir = argv[0] if argv else os.path.join(
        HERE, "joint_tensorf_tpu_torch", "_build", "variants")
    setup_torch()
    cuda_build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    run_k3(out_dir, gen)
    if only_k3:
        return

    src = open(os.path.join(cuda_build.CSRC, "composite.cu")).read()
    inputs = {S: cs.composite_inputs(2028, S, gen)[:3] for S in (221, 1000)}
    for nt, k in ((32, 4), (32, 8), (64, 4), (64, 8), (128, 2), (128, 4),
                  (128, 8)):
        lib, log = build(out_dir, f"k1_{nt}x{k}", "composite", edit(
            src, (K1_SHAPE[0], f"constexpr int kFwdRayThreads = {nt};"),
            (K1_SHAPE[1], f"  return (int)launch_fwd<{k}>(A, s);")))
        fn = lib.composite_fwd
        fn.argtypes, fn.restype = C._FWD_ARGTYPES, ctypes.c_int
        row = {"variant": f"K1 {nt} threads a ray x {k} samples a thread",
               "ptxas": ptxas(log, "composite_fwd_kernel")}
        for S, (alpha, rgb, z) in inputs.items():
            out = [torch.empty((2028, 3), device="cuda"),
                   torch.empty(2028, device="cuda"),
                   torch.empty(2028, device="cuda"),
                   torch.empty((2028, S), device="cuda")]

            def run():
                cuda_build.check(fn(
                    alpha.data_ptr(), rgb.data_ptr(), z.data_ptr(), 1e-6,
                    *(t.data_ptr() for t in out), 2028, S,
                    torch.cuda.current_stream().cuda_stream), "variant")

            run()
            torch.cuda.synchronize()
            row[f"S={S}"] = {
                "device_ms": cs.device_ms(run, "composite_fwd_kernel"),
                "max_abs_err": cs.max_err(out, C.composite_fwd_plain(
                    alpha, rgb, z, 1e-6))}
        print(json.dumps(row), flush=True)

    cases = {}
    for H, N, samples in ((400, 2028 * 1000, "march"),
                          (300, 2000000, "uniform")):
        if samples == "march":
            x, y = cs.march_points(2028, N // 2028, H, H, gen)
            u, v = x * (2.0 / (H - 1)) - 1.0, y * (2.0 / (H - 1)) - 1.0
        else:
            u, v = (torch.rand((N,), generator=gen, device="cuda") * 2 - 1
                    for _ in range(2))
        g = torch.randn((N, 64), generator=gen, device="cuda")
        bins = K4.pixel_bins(u, v, H, H)
        cases[f"{H}^2 {samples}"] = (H, g, bins, K4.plane_grad_scatter_plain(
            g, *bins, H, H))
    src = open(os.path.join(cuda_build.CSRC, "binned_scatter.cu")).read()
    for name, (vsrc, right) in k4_variants(src).items():
        lib, log = build(out_dir, "k4_" + name, "binned_scatter", vsrc)
        for sym, argtypes in (("binned_bucket", K4._BUCKET_ARGTYPES),
                              ("binned_plane_scatter", K4._ACC_ARGTYPES)):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            cuda_build._FNS[sym] = fn
        row = {"variant": "K4 " + name, "right": right,
               "ptxas": ptxas(log, "binned_plane_scatter_kernel")}
        for case, (H, g, bins, want) in cases.items():
            got = K4.plane_grad_scatter_cuda(g, *bins, H, H)
            bk, buf = K4.bucket_by_tile(bins[0], bins[1], H, H, 64)
            row[case] = {
                "kernel_device_ms": cs.device_ms(
                    lambda: K4.accumulate(g, bk, buf, bins[2], bins[3]),
                    "binned_plane_scatter_kernel"),
                "route_device_ms": sum(cs.device_times(
                    lambda: K4.plane_grad_scatter_cuda(g, *bins, H,
                                                       H)).values()),
                "max_abs_err": float((got - want).abs().max()),
                "max_abs_out": float(want.abs().max())}
        print(json.dumps(row), flush=True)
    cuda_build._FNS.clear()


if __name__ == "__main__":
    main(sys.argv[1:])
