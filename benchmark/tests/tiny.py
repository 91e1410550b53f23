"""A checkout of the benchmark with every configuration in BENCHMARK.json
cut to a size the CPU runs in seconds, for the CPU tests: the same cells,
traffic mixes, readers and limits.

Each configuration ``<c>`` brings its cut as ``tiny_cuts/<c>.json``
beside this file: dotted keys of its ``options`` and the values they take
(BAT's: 16 x 16 images, 4 views, 16^3 -> 32^3 voxels, S 64, 64 rays,
schedules of 50 and 400 iterations).  Where one is missing,
``make_tiny_root`` raises and names the file, so no model reaches the CPU
tests at full size."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def set_dotted(d: dict, dotted: str, value):
    parts = dotted.split(".")
    for p in parts[:-1]:
        d = d[p]
    d[parts[-1]] = value


def make_tiny_root(dst: str) -> str:
    """A copy of BENCHMARK.json and benchmark/ under ``dst`` with each
    configuration cut by its ``tiny_cuts/<c>.json``; returns ``dst``."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    for c in configs:
        cut = os.path.join(HERE, "tiny_cuts", c["name"] + ".json")
        if not os.path.isfile(cut):
            raise FileNotFoundError(
                f"the configuration {c['name']!r} has no tiny cut for the "
                f"CPU tests: {cut} is missing")
        with open(cut) as f:
            over = json.load(f)
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        for k, v in over.items():
            set_dotted(cfg["options"], k, v)
        with open(path, "w") as f:
            json.dump(cfg, f)
    return dst
