#!/usr/bin/env python
"""K3, the row scatter-add, of one or more checkouts of the PyTorch port at
the shapes chip_smoke.py checks it at, on one NVIDIA GPU.

    python3 scripts/chip_k3_shapes.py TREE [TREE ...]

Prints the card's name and power limit (nvidia-smi), then runs each TREE
(the repository root, or an unpacked ``git archive`` of another commit) in
a fresh process, in the order given: the process imports that checkout's
joint_tensorf_tpu_torch, builds its segment_scatter kernel and runs this
checkout's chip_smoke.check_scatter at each shape (rows in march order
from one seed; K3 held against index_add_; the wrapper, the plain version
and index_add_ timed back to back, and the wrapper's device activities by
name from torch.profiler).  One JSON line per tree and shape.  To compare
two commits on one card, alternate them:

    python3 scripts/chip_k3_shapes.py PARENT . . PARENT
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, check_scatter's n_rays, S, H, W, C, grid3d): chip_smoke.py's K3
# shapes (its runs reach the 423x359x420 grid, whose largest plane is
# 420 x 423)
SHAPES = [
    ("first phase: appearance planes", 2028, 64, 64, 64, 192, None),
    ("first phase: dense grid", 2028, 221, 0, 0, 8, (64, 64, 64)),
    ("last phase: density planes", 2028, 512, 420, 423, 64, None),
    ("last phase: appearance planes", 2028, 128, 420, 423, 192, None),
    ("fused planes into 64^2", 2028, 221, 64, 64, 256, None),
    ("fused planes into 400^2", 2028, 221, 400, 400, 256, None),
    ("alternatives off: fused planes", 2028, 640, 420, 423, 256, None),
    ("blurred phase: dense grid of 64M voxels", 2028, 1000, 0, 0, 8,
     (423, 359, 420)),
]


def run_tree(tree: str):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_k3_shapes: no CUDA device")
    # this checkout's chip_smoke.py, loaded by path (TREE may hold another)
    spec = importlib.util.spec_from_file_location(
        "k3_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.utils import setup_torch

    setup_torch()
    cuda_build.build_all(["segment_scatter"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, n_rays, S, H, W, C, grid3d in SHAPES:
        row = cs.check_scatter(n_rays, S, H, W, C, gen, tol=1e-5,
                               grid3d=grid3d)
        print(json.dumps({"tree": tree, "label": label, **row}), flush=True)
        torch.cuda.empty_cache()


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        return run_tree(argv[1])
    if not argv:
        raise SystemExit("usage: python3 scripts/chip_k3_shapes.py TREE "
                         "[TREE ...]")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi printed nothing",
          flush=True)
    for tree in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
