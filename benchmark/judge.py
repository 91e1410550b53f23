"""The comparison that decides ``correct``: the program's first steps
against the reference's, by the numbers below that limits/<cell>.json
names, each held to its limit there; the others are logged.

- ``loss_gap``: the first step's |loss_p - loss_r| / |loss_r|.  The
  later steps' gaps are logged, not judged: once the two sides'
  parameters differ by rounding, a later step can pick other samples
  where the two-stage appearance's top-k cuts through nearly equal
  weights, and read 40 times the first step's gap on a sound run
  (PERF.md, PR 19);
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  first gradient, | |g_p| - |g_r| |, over the reference's norm of that leaf
  or of the median leaf, whichever is larger;
- ``change_gap``: the same of the norms of each leaf's change over the
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf whose gradient is nought to rounding moves
  under Adam by round-off alone);
- ``median_change_gap``: the median over those leaves of the same gap.
  The worst leaf's swings from seed to seed: its largest share comes from
  elements whose gradient sits near Adam's eps, 1e-8, where a step
  follows the raw gradient, and the later steps' gradients there differ
  with the samples the later steps pick (PERF.md, PR 22); the median is
  steady and separates the control.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "median_change_gap")
MOVING = 1e-3       # a leaf counts for the change past this share of the
                    # median leaf's first gradient


def _gaps(prog: dict, ref: dict, leaves) -> dict:
    floor = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves}


def _worst(prog: dict, ref: dict, leaves) -> tuple:
    gaps = _gaps(prog, ref, leaves)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def readings(prog: dict, ref: dict) -> dict:
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError(f"leaves differ: program {sorted(prog['grad_norms'])}"
                         f", reference {sorted(ref['grad_norms'])}")
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    leaves = sorted(ref["grad_norms"])
    grad, grad_leaf = _worst(prog["grad_norms"], ref["grad_norms"], leaves)
    gmed = statistics.median(ref["grad_norms"].values())
    moving = [k for k in leaves if ref["grad_norms"][k] >= MOVING * gmed]
    change, change_leaf = _worst(prog["change_norms"], ref["change_norms"],
                                 moving)
    median = statistics.median(_gaps(prog["change_norms"],
                                     ref["change_norms"], moving).values())
    return {"loss_gap": steps[0], "grad_gap": grad, "change_gap": change,
            "median_change_gap": median,
            "step_loss_gaps": steps,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": [k for k in leaves if k not in moving]}


def checks(read: dict, limits: dict) -> dict:
    """The numbers the cell's limits name, each beside its limit (a number
    a cell leaves out is named in PERF.md with its readings)."""
    return {k: {"value": read[k], "limit": float(limits[k]["limit"])}
            for k in NUMBERS if k in limits}


def correct(check: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in check.values())
