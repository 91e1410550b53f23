"""The look behind a BAT cell's ``change_gap``: which elements of each leaf
make the gap between the program's and the reference's norms of the
change over the compared steps, and how large their first gradients are.

    python3 -m benchmark.tools.look OUT.json CELL SEED [SEED ...]

For each seed: the program's first steps as a run drives them (the
model's ``build`` and the trainer's ``run``), keeping each leaf's change
and first gradient (Adam's first moment over 1 - b1) element by element;
then the reference over the same steps, kept the same way.  Per leaf it
writes the gap as judge.py reads it and the sum of (d_p^2 - d_r^2) over
the elements, split by the size of the reference's first gradient
(|g_r| by decade, 1e-13 and below together, 0 as -99), so that the
elements that make the gap show; and the ten elements that add most.  At the cell's own size, on
the card; writes OUT.json after every seed.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import sys

import torch

from .. import judge, spec


class _Kept:
    """Mixed into the model's Reference: keeps the weights after the
    replay and the first gradient of every leaf."""

    def replay(self):
        super().replay()
        self.start_p = {k: v.detach().clone() for k, v in self.p.items()}

    def _adam(self, names, grads, lrs, state, b2, store):
        if state["count"] == 0:
            self.g1.update({k: grads[k].detach().clone() for k in names})
        super()._adam(names, grads, lrs, state, b2, store)


def _leaf(d_p, d_r, g_r, g_p) -> dict:
    d_p, d_r = d_p.double().flatten(), d_r.double().flatten()
    g_r, g_p = g_r.double().flatten().abs(), g_p.double().flatten().abs()
    contrib = d_p ** 2 - d_r ** 2
    dec = torch.where(g_r > 0, torch.log10(g_r).floor().clamp(-13, -2),
                      torch.full_like(g_r, -99.0))
    buckets = []
    for d in torch.unique(dec).tolist():
        sel = dec == d
        buckets.append({"g_r_decade": d, "n": int(sel.sum()),
                        "sum_dp2_minus_dr2": float(contrib[sel].sum()),
                        "sum_abs": float(contrib[sel].abs().sum()),
                        "moved_one_side": int((sel & ((d_p == 0)
                                               != (d_r == 0))).sum())})
    top = torch.argsort(contrib.abs(), descending=True)[:10]
    return {"n_p": float(d_p.norm()), "n_r": float(d_r.norm()),
            "sum_dp2_minus_dr2": float(contrib.sum()),
            "buckets": buckets,
            "top": [{"i": int(i), "g_r": float(g_r[i]), "g_p": float(g_p[i]),
                     "d_p": float(d_p[i]), "d_r": float(d_r[i])}
                    for i in top]}


def look(root: str, cell_name: str, seed: int, device="cuda") -> dict:
    cell = spec.cell(root, cell_name)
    model, opts = cell.model, cell.config["options"]
    dev = torch.device(device)
    n = int(cell.traffic["check_steps"])
    inputs = model.make_inputs(
        opts, seed, cell.start_it, dev,
        warm_radii=float(cell.config.get("warm_radii") or 0.0))
    trainer = model.build(inputs, dev)
    before = {k: v.detach().clone() for k, v in model.params(trainer).items()}
    g_p, losses = {}, []

    def on_step(tr, metrics):
        if metrics is None:
            return
        losses.append(float(metrics["loss"]))
        if not g_p:
            mu = dict(tr.state.scene_opt.mu)
            mu["se3_refine"] = tr.state.pose_opt.mu["se3_refine"]
            g_p.update({k: (m / (1 - model.ADAM_B1)).detach().cpu()
                        for k, m in mu.items()})

    trainer.run(max_iter=trainer.it + n,
                log_every=int(opts["freq"]["scalar"]), on_step=on_step)
    d_p = {k: (v.detach() - before[k]).cpu()
           for k, v in model.params(trainer).items()}
    del trainer, before
    gc.collect()
    torch.cuda.empty_cache()

    ref = type("LookReference", (_Kept, model.Reference), {})(inputs, dev)
    ref.g1 = {}
    got = ref.run(n)
    now = dict(ref.p)
    d_r = {k: (now[k] - ref.start_p[k]).cpu() for k in ref.p}
    g_r = {k: v.cpu() for k, v in ref.g1.items()}
    leaves = sorted(d_r)       # the field's; the pose leaf is the run's own
    prog = {"losses": losses,
            "grad_norms": {k: float(v.norm()) for k, v in g_p.items()},
            "change_norms": {k: float(v.norm()) for k, v in d_p.items()}}
    read = judge.readings(prog, got)
    gmed = statistics.median(got["grad_norms"].values())
    out = {"seed": seed, "checks": {k: read[k] for k in judge.NUMBERS},
           "change_leaf": read["change_leaf"], "grad_leaf": read["grad_leaf"],
           "median_grad_norm": gmed,
           "median_change_norm": statistics.median(
               got["change_norms"][k] for k in leaves
               if got["grad_norms"][k] >= judge.MOVING * gmed),
           "leaves": {k: _leaf(d_p[k], d_r[k], g_r[k], g_p[k])
                      for k in leaves}}
    return out


def main(argv) -> int:
    out, cell, seeds = argv[0], argv[1], [int(s) for s in argv[2:]]
    root = spec.root_of()
    rows = []
    for seed in seeds:
        rows.append({"cell": cell, **look(root, cell, seed)})
        r = rows[-1]
        print(json.dumps({k: r[k] for k in ("seed", "checks", "change_leaf")}
                         ), flush=True)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "rows": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
