"""The upper readings of a cell's correctness numbers: the reference put
in the program's place in the nearest precision below the configuration's
(float32 with TF32 on, against the reference's float32 with TF32 off), and
the faults the check must catch planted in the reference ("half_batch":
the loss over half the rays; "answer": every rendered colour raised by
1e-3), each compared with the sound reference as a run compares the
program.  A state left unchanged reads 1 on change_gap and
median_change_gap by definition.

    python3 -m benchmark.tools.control OUT.json CELL SEED [SEED ...]
    python3 -m benchmark.tools.control --witness OUT.json CELL SEED ...

``--witness`` reads the sound reference against itself with every sample
moved by 2^-22 of its depth instead: where that moves a number as far as
the program's runs do, the cause lies in the function's kinks.

At the cell's own size, on the card; writes OUT.json after every seed.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from .. import judge, spec

VARIANTS = (("tf32", {"tf32": True}), ("half_batch", {"fault": "half_batch"}),
            ("answer", {"fault": "answer"}))
# a second witness, not a control: the sound reference with its samples
# moved by 2^-22 of their depth
WITNESS = ("nudge", {"nudge": 2.0 ** -22})


def readings(root: str, cell_name: str, seed: int, device="cuda",
             variants=VARIANTS) -> dict:
    cell = spec.cell(root, cell_name)
    inputs = cell.model.make_inputs(
        cell.config["options"], seed, cell.start_it, device,
        warm_radii=float(cell.config.get("warm_radii") or 0.0))
    n = int(cell.traffic["check_steps"])
    t0 = time.perf_counter()
    ref = cell.model.Reference(inputs, device).run(n)
    torch.cuda.synchronize(device)
    out = {"reference_s": time.perf_counter() - t0}
    for name, kw in variants:
        got = cell.model.Reference(inputs, device, **kw).run(n)
        read = judge.readings(got, ref)
        out[name] = {k: read[k] for k in judge.NUMBERS}
        out[name]["step_loss_gaps"] = read["step_loss_gaps"]
        out[name]["leaves"] = [read["grad_leaf"], read["change_leaf"]]
        out[name]["grad_norms"] = got["grad_norms"]
    out["grad_norms"] = ref["grad_norms"]
    return out


def main(argv) -> int:
    variants = VARIANTS
    if argv[0] == "--witness":
        variants, argv = (WITNESS,), argv[1:]
    out, cell, seeds = argv[0], argv[1], [int(s) for s in argv[2:]]
    root = spec.root_of()
    rows = []
    for seed in seeds:
        rows.append({"cell": cell, "seed": seed,
                     **readings(root, cell, seed, variants=variants)})
        print(json.dumps(rows[-1]), flush=True)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "rows": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
