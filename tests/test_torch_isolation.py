"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX
package, nor the root modules the port's graft_entry, run_experiments and
bench stand for: a fresh interpreter with all of them blocked imports
every module."""
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["joint_tensorf_tpu"] = None
# the root modules the port's graft_entry, run_experiments and bench
# stand for
sys.modules["__graft_entry__"] = None
sys.modules["run_experiments"] = None
sys.modules["bench"] = None
import joint_tensorf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
assert {"joint_tensorf_tpu_torch.graft_entry",
        "joint_tensorf_tpu_torch.run_experiments",
        "joint_tensorf_tpu_torch.bench"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib"))
               for k, v in sys.modules.items() if v is not None)
print("imported", len(names))
"""


def test_port_imports_no_jax():
    import joint_tensorf_tpu_torch as pkg

    n_modules = len(list(pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"imported {n_modules}"
    assert n_modules >= 20
