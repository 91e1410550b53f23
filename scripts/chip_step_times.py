#!/usr/bin/env python
"""Step times of one checkout of the PyTorch port on one NVIDIA GPU.

    python3 scripts/chip_step_times.py TREE

Imports chip_smoke.py from the checkout TREE (the repository root, or an
unpacked ``git archive`` of another commit), builds that checkout's
kernels, and runs only its training drives: chip_smoke's main path (20
full-width first-phase steps) and its full-width runs through every phase
(on the default tpu: path and with the alternatives off, where the
checkout has both; one run on checkouts from before the tpu: path).
Prints one JSON line: the median step of the main path and of each phase,
in ms.  Each call is one fresh process, so that the kernel checks of a full
chip_smoke run do not precede the steps; to compare two commits on one
card, alternate them on one machine, e.g.

    for t in A B A B A B B A; do python3 scripts/chip_step_times.py $t; done
"""
import contextlib
import io
import json
import os
import sys


def main(argv):
    if len(argv) != 1:
        raise SystemExit("usage: python3 scripts/chip_step_times.py TREE")
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_step_times: no CUDA device")
    import chip_smoke
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.utils import setup_torch

    setup_torch()
    cuda_build.build_all()
    main_path = chip_smoke.run_main_path(chip_smoke.N_STEPS)[0]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if hasattr(chip_smoke, "ALTERNATIVES_OFF"):
            chip_smoke.run_all_phases("tpu_default")
            chip_smoke.run_all_phases("alternatives_off",
                                      chip_smoke.ALTERNATIVES_OFF)
        else:
            chip_smoke.run_all_phases()
    runs = {}
    for line in out.getvalue().splitlines():
        if line.startswith('{"all_phases'):
            (key, run), = json.loads(line).items()
            runs[key] = [p["step_ms_median"] for p in run["phases"]]
    print(json.dumps({
        "tree": argv[0], "device": torch.cuda.get_device_name(0),
        "main_step_ms_median": main_path["main_path"]["step_ms_median"],
        "phase_step_ms_median": runs}))


if __name__ == "__main__":
    main(sys.argv[1:])
