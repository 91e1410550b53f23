"""The benchmark is driven by data: BENCHMARK.json keeps the contract's
shape, and a cell, a configuration, a traffic mix and a per-layer metric
are added by adding files, with no edit to any file already there."""
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
import xml.etree.ElementTree as ET

import pytest

from benchmark import harness, judge, spec
from benchmark.tests.tiny import BENCH, HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = spec.load(ROOT)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", spec.cells(ROOT))
def test_every_cell_resolves(name):
    cell = spec.cell(ROOT, name)
    assert cell.start_it > 0 and cell.per_layer and cell.end_to_end
    assert {"loss_gap", "median_change_gap"} <= set(cell.limits) <= set(
        judge.NUMBERS)
    for m in cell.per_layer:
        assert callable(spec.reader(ROOT, m["name"]))


def _checkout(tmp_path) -> tuple:
    """A copy of BENCHMARK.json and benchmark/, and the bytes of every file
    under its benchmark/."""
    root = str(tmp_path / "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {}
    for dirpath, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(dirpath, f)
            before[p] = open(p, "rb").read()
    return root, before


def test_a_cell_is_added_by_files_alone(tmp_path):
    root, before = _checkout(tmp_path)
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "bat_blender.json")))
    cfg["options"]["model"] = "bat"
    json.dump(cfg, open(os.path.join(b, "configs", "bat_blender_b.json"),
                        "w"))
    json.dump({"why": "one past the second mask update",
               "start": {"after": "update_alphamask_iters", "index": 0},
               "check_steps": 3, "warmup_steps": 2, "chunk_steps": 1,
               "trace_steps": 4},
              open(os.path.join(b, "traffic", "mask_one.json"), "w"))
    json.dump({k: {"limit": 1.0} for k in
               ("loss_gap", "grad_gap", "change_gap")},
              open(os.path.join(b, "limits", "bat_blender_b.mask_one.json"),
                   "w"))
    with open(os.path.join(b, "metrics", "steps_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.steps)\n")
    # BENCHMARK.json gains entries; no file under benchmark/ changes
    bench = spec.load(root)
    bench["configs"].append(dict(bench["configs"][0], name="bat_blender_b",
                                 file="benchmark/configs/bat_blender_b.json"))
    bench["workloads"].append({"name": "bat_blender_b.mask_one",
                               "config": "bat_blender_b",
                               "traffic": "mask_one", "chips": 1,
                               "why": "added by files"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source":
                               "program_counter", "layer": "device",
                               "moves": "train_rays_per_s"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    assert "bat_blender_b.mask_one" in spec.cells(root)
    cell = spec.cell(root, "bat_blender_b.mask_one")
    assert cell.start_it == 12001
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    assert spec.reader(root, "steps_traced")(type("C", (), {"steps": 4})) \
        == 4.0
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def _add_stub(root: str, model: str = "stub"):
    """A second model added as files, as a real one is: models/stub.py
    (tests/stub_model.py), its configuration and its tiny cut for the CPU
    tests, a traffic mix that starts at an absolute iteration, the cell's
    limits, a per-layer metric of its own, and BENCHMARK.json's
    entries."""
    b = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(HERE, "stub_model.py"),
                os.path.join(b, "models", "stub.py"))
    json.dump({"source": "a least-squares stub", "warm_radii": 0.0,
               "options": {"model": model, "freq": {"scalar": 4},
                           "data": {"seed": 3}, "batches": 4, "rows": 32,
                           "width": 16, "lr": 0.01}},
              open(os.path.join(b, "configs", "stub_fit.json"), "w"))
    json.dump({"rows": 16},
              open(os.path.join(b, "tests", "tiny_cuts", "stub_fit.json"),
                   "w"))
    json.dump({"why": "from iteration 5, no schedule",
               "start": {"iteration": 5}, "check_steps": 3,
               "warmup_steps": 2, "chunk_steps": 2, "trace_steps": 4},
              open(os.path.join(b, "traffic", "fit.json"), "w"))
    json.dump({k: {"limit": 1e-6} for k in judge.NUMBERS},
              open(os.path.join(b, "limits", "stub_fit.fit.json"), "w"))
    with open(os.path.join(b, "metrics", "stub_steps.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.steps)\n")
    bench = spec.load(root)
    bench["configs"].append({"name": "stub_fit", "source": "none",
                             "file": "benchmark/configs/stub_fit.json",
                             "reduced": [], "why": "a second model"})
    bench["workloads"].append({"name": "stub_fit.fit", "config": "stub_fit",
                               "traffic": "fit", "chips": 1,
                               "why": "added by files"})
    bench["per_layer"].append({"name": "stub_steps", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "stub trainer",
                               "moves": "train_rays_per_s",
                               "workloads": ["stub_fit.fit"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))


def test_a_model_is_added_by_files_alone(tmp_path, monkeypatch):
    """A second model, a stub trainer that keeps the trainer contract, is
    resolved by spec.cell, run through harness.run (window and traced
    span) with ``correct`` true, and read by the census readers, with no
    file already under benchmark/ changed."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root, before = _checkout(tmp_path)
    _add_stub(root)
    cell = spec.cell(root, "stub_fit.fit")
    assert cell.start_it == 5 and cell.model.__name__.endswith("stub")
    for trace in (False, True):
        r = harness.run(root, "stub_fit.fit", 2 ** 31 + 5, 0.2, trace,
                        time.perf_counter(), device="cpu")
        assert r["correct"], r["checks"]
        assert set(r["checks"]) == set(judge.NUMBERS)
        assert r["attempted"] > 0 and r["failed"] == 0
        if not trace:
            assert {"train_rays_per_s", "setup_s"} <= set(r["metrics"])
    ctx = types.SimpleNamespace(
        steps=4, shape=cell.model.step_shape(cell, {"rows": 32}),
        census=cell.model.census, span=types.SimpleNamespace(window_s=4e-3))
    assert spec.reader(root, "step_mfu")(ctx) == pytest.approx(
        100 * 3 * 2 * 32 * 16 / 67e12 / 1e-3)
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_a_model_without_a_module_is_named(tmp_path):
    root, _ = _checkout(tmp_path)
    _add_stub(root, model="nomodel")
    with pytest.raises(FileNotFoundError, match=r"models.nomodel\.py"):
        spec.cell(root, "stub_fit.fit")


MODEL_WORDS = ("tensorf", "compact_k", "app_k", "train_schedule",
               "state.field", "reference.step",
               "joint_tensorf_tpu_torch.train.trainer")


@pytest.mark.parametrize("module", ["harness.py", "spec.py", "program.py",
                                    "inputs.py"])
def test_the_harness_is_model_blind(module):
    """The modules every cell runs name nothing of one model: that is
    models/<model>.py's."""
    text = open(os.path.join(BENCH, module)).read()
    assert [w for w in MODEL_WORDS if w in text] == []


def test_a_configuration_without_a_tiny_cut_is_named(tmp_path):
    root, _ = _checkout(tmp_path)
    _add_stub(root)
    cut = os.path.join(root, "benchmark", "tests", "tiny_cuts",
                       "stub_fit.json")
    os.remove(cut)
    tiny = importlib.util.spec_from_file_location(
        "copy_tiny", os.path.join(root, "benchmark", "tests", "tiny.py"))
    module = importlib.util.module_from_spec(tiny)
    tiny.loader.exec_module(module)
    with pytest.raises(FileNotFoundError, match=re.escape(cut)):
        module.make_tiny_root(str(tmp_path / "tiny"))


def _outcomes(report: str) -> dict:
    """(test module, test id) -> outcome, from a JUnit XML report."""
    got = {}
    for case in ET.parse(report).iter("testcase"):
        tags = {child.tag for child in case}
        outcome = next((t for t in ("failure", "error", "skipped")
                        if t in tags), "passed")
        got[(case.get("classname").rsplit(".", 1)[-1],
             case.get("name"))] = outcome
    return got


def test_the_benchmark_tests_take_a_new_model_by_files(tmp_path):
    """The benchmark's own tests, run on a copy to which the stub's cell
    was added as files alone, take it: it resolves, agrees with its
    reference on the CPU and is collected for the control on the card
    (which skips without one), the pin leaves it out, and no file that
    was already in the copy changes."""
    root, before = _checkout(tmp_path)
    _add_stub(root)
    report = str(tmp_path / "report.xml")
    # the copy's benchmark first, the port this process finds after it; no
    # card, so that the control's case skips wherever this runs
    port = os.path.dirname(os.path.dirname(
        importlib.util.find_spec("joint_tensorf_tpu_torch").origin))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, port]),
               PYTHONDONTWRITEBYTECODE="1", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-k", "stub_fit",
         "-p", "no:cacheprovider", "--basetemp", str(tmp_path / "inner"),
         "--junitxml", report, os.path.join(root, "benchmark", "tests")],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    got = _outcomes(report)
    assert got == {
        ("test_harness_layout", "test_every_cell_resolves[stub_fit.fit]"):
        "passed",
        ("test_harness_reference",
         "test_reference_agrees_with_the_port[stub_fit.fit]"): "passed",
        ("test_harness_control",
         "test_control_and_faults_fail[stub_fit.fit]"): "skipped"}, got
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
