"""PyTorch port vs JAX: the root entry points (joint_tensorf_tpu_torch/
graft_entry.py against the repository's root __graft_entry__.py).

* entry(device="cpu") renders the same rays as JAX's entry(): JAX's state
  carried into the port (convert.py), JAX's rays and JAX's stratified
  draws (the renderer's split of PRNGKey(1)); rgb, depth and opacity
  within 1e-5 of the render's largest output (rgb ~1 on the white
  background: the fresh field's opacities are ~3e-3, computed as 1 - T
  with T near 1, so float32 leaves them ~1e-7 apart, 1e-4 of their own
  size); the port's own entry state
  is init_vm's on a generator seeded 0, and its render is finite;
* entry and dryrun_multichip without a device on a host without a card
  raise;
* dryrun_multichip(2) and (4) as gloo ranks on the CPU: every section's
  assertions hold on every rank (a finite loss, the pose table moved, 1/C
  of the components a rank, the alpha mask built, one gradient
  all-reduce a step, the restored leaves equal and replicated, the
  resumed and the L2G steps finite), and the ranks agree.
"""
import jax
import numpy as np
import pytest
import torch
from torch_parity import flatten_field

import __graft_entry__ as jentry
from joint_tensorf_tpu_torch import graft_entry
from joint_tensorf_tpu_torch.convert import field_from_numpy
from joint_tensorf_tpu_torch.models.vm import init_vm
from joint_tensorf_tpu_torch.utils import setup_torch

setup_torch()


def test_entry_matches_jax():
    jfn, (jstate, centers, dirs, key, near_far, c2f) = jentry.entry()
    want = [np.asarray(o) for o in jax.jit(jfn)(jstate, centers, dirs, key,
                                                near_far, c2f)]
    fn, args = graft_entry.entry(device="cpu")
    field = field_from_numpy(flatten_field(jstate), graft_entry._vm_config())
    # JAX's renderer draws its stratified offsets from the first half of
    # the split key (render_rays: rng_samp, rng_bg = split(rng))
    jitter = torch.as_tensor(np.array(jax.random.uniform(
        jax.random.split(key)[0], (centers.shape[0], 1))))
    with torch.no_grad():
        got = fn(field, torch.as_tensor(np.array(centers)),
                 torch.as_tensor(np.array(dirs)), jitter,
                 tuple(float(x) for x in np.asarray(near_far)), float(c2f))
    assert len(got) == len(want) == 3
    largest = max(float(np.abs(w).max()) for w in want)
    for name, g, w in zip(("rgb", "depth", "opacity"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * largest, err_msg=name)
    # the rays and the example's own state
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(centers))
    np.testing.assert_allclose(args[2].numpy(), np.asarray(dirs), atol=1e-7)
    ref = init_vm(graft_entry._vm_config(), (32, 32, 32), graft_entry.AABB,
                  torch.Generator().manual_seed(0))
    for (k, a), b in zip(args[0].named_parameters(), ref.parameters()):
        assert torch.equal(a, b), k
    with torch.no_grad():
        out = fn(*args)
    assert [tuple(o.shape) for o in out] == [(256, 3), (256,), (256,)]
    assert all(torch.isfinite(o).all() for o in out)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n, capsys):
    out = graft_entry.dryrun_multichip(n, device="cpu", timeout_s=300)
    assert len(out) == n
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(":")[1].split()[0] for line in printed
            if line.startswith(f"dryrun_multichip({n})")] == [
        "OK", "trainer", "sharded", "L2G"]
    comp = 2
    assert out[0]["step"]["mesh"] == {"rays": n // comp, "comp": comp}
    assert out[0]["l2g"]["mesh"] == {"rays": n // comp, "comp": comp}
    assert out[0]["resume"] == {"resumed_it": 12, "steps": 4}
    for r in out:
        assert np.isfinite(r["step"]["loss"]) and r["step"]["pose_delta"] > 0
        # the reduced loss and the replicated trainer agree on every rank
        assert r["step"]["loss"] == out[0]["step"]["loss"]
        assert r["trainer"] == out[0]["trainer"]
        assert r["l2g"]["loss"] == out[0]["l2g"]["loss"]
