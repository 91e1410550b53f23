"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference loads nothing of the port either."""
import ast
import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "joint_tensorf_tpu"}

RUN_MODULES = ["benchmark.run", "benchmark.harness", "benchmark.program",
               "benchmark.trace", "benchmark.tools.sweep",
               "benchmark.tools.control"]
MODELS = sorted(f"benchmark.models.{f[:-3]}" for f in
                os.listdir(os.path.join(BENCH, "models"))
                if f.endswith(".py") and f != "__init__.py")


def _loaded(modules, extra="") -> set:
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n    importlib.import_module(m)\n"
            f"{extra}"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    readers = [f"benchmark.metrics.{f[:-3]}" for f in
               sorted(os.listdir(os.path.join(BENCH, "metrics")))
               if f.endswith(".py")]
    loaded = _loaded(RUN_MODULES + MODELS + readers)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "joint_tensorf_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(["benchmark.reference.step", "benchmark.judge",
                      "benchmark.census.counts", "benchmark.inputs"])
    assert not loaded & (FORBIDDEN | {"joint_tensorf_tpu_torch"}), loaded


@pytest.mark.parametrize("sub", ["reference", "census"])
def test_yardstick_sources_import_no_program(sub):
    """Every import statement under reference/ and census/ names the
    standard library, numpy, torch or the benchmark itself."""
    allowed = {"__future__", "dataclasses", "math", "statistics",
               "subprocess", "typing", "numpy", "torch", "benchmark"}
    d = os.path.join(BENCH, sub)
    for f in sorted(os.listdir(d)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(d, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (f, n)
