"""The benchmark's data: BENCHMARK.json at the checkout's root and the
files it names, found by name so that a cell, a configuration, a traffic
mix or a per-layer metric is added by adding files.

- a configuration ``<c>``: ``configs/<file>`` as BENCHMARK.json names it,
  whose ``options`` are the configuration as run;
- a model ``<m>``: ``models/<m>.py`` (models/__init__.py), found from the
  configuration's ``options["model"]``;
- a traffic mix ``<t>``: ``traffic/<t>.json``, the cell's first
  iteration (an anchor that the model's ``start_iteration`` reads) and
  the steps it runs;
- a per-layer metric ``<m>``: ``metrics/<m>.py`` with ``read(ctx)``;
- a cell's correctness limits: ``limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    chips: int
    end_to_end: list      # this cell's end-to-end metric entries
    per_layer: list       # this cell's per-layer metric entries
    limits: dict          # number -> {"limit": ...}
    start_it: int
    model: object         # models/<options["model"]>.py


def root_of(bench_dir: str = HERE) -> str:
    return os.path.dirname(bench_dir)


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def model_module(root: str, model: str):
    """models/<model>.py of the checkout at ``root``."""
    bench = load(root)
    path = os.path.join(root, bench["paths"][0], "models", model + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"the configuration's model {model!r} has "
                                f"no module: {path} is missing")
    return _load(path, f"benchmark_model_{model.replace('.', '_')}")


def cells(root: str) -> list:
    return [w["name"] for w in load(root)["workloads"]]


def cell(root: str, name: str) -> Cell:
    bench = load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bdir = os.path.join(root, bench["paths"][0])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bdir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(bdir, "limits", name + ".json")
    with open(limits_path) as f:
        limits = json.load(f)
    model = model_module(root, str(config["options"]["model"]))
    start = int(model.start_iteration(config["options"], traffic["start"]))
    moves = model.schedule_moves(config["options"], start,
                                 int(traffic["check_steps"]))
    if moves:
        raise ValueError(f"{name}: the schedule changes the field after "
                         f"iteration(s) {moves}, inside the compared steps")
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _for_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _for_cell(m, name)],
        limits=limits, start_it=start, model=model)


def reader(root: str, metric: str):
    """The ``read(ctx)`` of metrics/<metric>.py."""
    bench = load(root)
    path = os.path.join(root, bench["paths"][0], "metrics", metric + ".py")
    return _load(path, f"benchmark_metric_{metric.replace('.', '_')}").read
