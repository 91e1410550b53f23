"""The port's bench (joint_tensorf_tpu_torch/bench.py) against the root
bench.py: the schedule weights, the capture protocol of
tests/test_bench_capture.py, the phases' budgets and choices at the smoke
shapes, and the command line (the CPU smoke mode runs; without a card
and without --device=cpu it refuses)."""
import copy
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from joint_tensorf_tpu_torch import bench as pbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The steps of this file on one host thread: beside the suite's other
    workers, torch's default of a thread a core makes them ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    """phase_setups at the smoke shapes on the CPU, shared: the tests run
    copies of its states."""
    return pbench.phase_setups(small=True, device="cpu")


def _root_bench():
    """The root bench.py, imported in the tests only."""
    return importlib.import_module("bench")


def test_schedule_weights_equal_the_root_bench():
    want = _root_bench().simulate_schedule_weights()
    assert pbench.simulate_schedule_weights() == want
    assert want == {"early": 0.225, "dense_blur": 0.073575,
                    "dense_sharp": 0.001425, "compacted": 0.7}


# ------------------------------------------------------- the capture protocol
def _m(ms):
    s = ms / 1000.0
    return {"median_s": s, "min_s": s * 0.99, "max_s": s * 1.01,
            "reps": 5, "iters": 10}


def _first_phase_alone(path):
    cap = pbench._Capture(2000)
    cap.record("compacted", _m(90.0))
    rec = json.loads(path.read_text())
    assert rec["metric"] == "rays_per_sec_train"
    assert rec["value"] > 0 and rec["partial"] is True
    # with no prior record the missing phases bill at the slowest known
    # time and are listed as carried
    assert set(rec["carried_phases"]) == {"early", "dense"}
    assert rec["detail"]["ms_early"] == rec["detail"]["ms_compacted"] == 90.0


def _carried_merge(path):
    path.write_text(json.dumps({
        "metric": "rays_per_sec_train", "value": 1.0,
        "captured_at": "earlier",
        "detail": {"ms_compacted": 80.0, "ms_early": 60.0,
                   "ms_dense": 200.0}}))
    cap = pbench._Capture(2000)
    cap.record("compacted", _m(40.0))
    rec = json.loads(path.read_text())
    assert rec["detail"]["ms_compacted"] == 40.0      # fresh
    assert rec["detail"]["ms_early"] == 60.0          # carried
    assert rec["detail"]["ms_dense"] == 200.0
    assert set(rec["carried_phases"]) == {"early", "dense"}
    w = pbench.simulate_schedule_weights()
    t = (w["early"] * 0.060 + (w["dense_blur"] + w["dense_sharp"]) * 0.200
         + w["compacted"] * 0.040)
    assert abs(rec["value"] - 2000 / t) < 1.0


def _full_capture(path):
    cap = pbench._Capture(2000)
    for ph, ms in (("compacted", 90.0), ("early", 60.0), ("dense", 300.0)):
        cap.record(ph, _m(ms))
    rec = cap.result(partial=False)
    assert "partial" not in rec and "carried_phases" not in rec
    assert rec["vs_baseline"] > 0


def _smoke_never_persists(path):
    pbench._SMALL = True      # restored by the monkeypatch below
    cap = pbench._Capture(256)
    cap.record("compacted", _m(5.0))
    cap.persist(partial=False)
    assert not path.exists(), "JTF_BENCH_SMALL must never write a record"


def _jax_record_untouched(path):
    root = _root_bench()
    assert os.path.normpath(root._LAST_GOOD) == os.path.join(
        ROOT, "docs", "bench", "last_bench.json")
    jax_rec = root._LAST_GOOD
    before = (os.stat(jax_rec).st_mtime_ns, open(jax_rec, "rb").read())
    # the port's record has a path of its own, ignored by git
    assert pbench._LAST_GOOD != root._LAST_GOOD
    gitignore = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "docs/bench/last_bench_torch.json" in gitignore
    det = json.loads(before[1])["detail"]
    cap = pbench._Capture(det["n_rays"], shape_sig=(
        det["res"], det["n_rays"], det["n_samples"]))
    assert cap.carried == {}           # nothing read from JAX's record
    for ph in ("compacted", "early", "dense"):
        cap.record(ph, _m(50.0))
    cap.persist(partial=False)
    assert path.exists()
    assert (os.stat(jax_rec).st_mtime_ns, open(jax_rec, "rb").read()) \
        == before


@pytest.fixture(scope="module")
def weights():
    return pbench.simulate_schedule_weights()


@pytest.mark.parametrize("case", [
    _first_phase_alone, _carried_merge, _full_capture, _smoke_never_persists,
    _jax_record_untouched], ids=lambda f: f.__name__.strip("_"))
def test_capture_protocol(case, monkeypatch, tmp_path, weights):
    """The root bench's four capture contracts (tests/test_bench_capture.py)
    on the port's _Capture, its record moved to tmp_path, and that the
    port never reads or writes JAX's record.  The schedule is simulated
    once for all cases (its weights are held to the root bench's above)."""
    path = tmp_path / "last_bench_torch.json"
    monkeypatch.setattr(pbench, "simulate_schedule_weights",
                        lambda: dict(weights))
    monkeypatch.setattr(pbench, "_SMALL", False)
    monkeypatch.setattr(pbench, "_LAST_GOOD", str(path))
    case(path)


# ----------------------------------------------------------- the probes
_SMOKE_VIEWS, _SMOKE_H, _SMOKE_W = 8, 64, 64


def _jax_probe_bbox_k(res_p, S, mask=None, pad=1.0, stride=4):
    """The root bench's closure (bench.py:359-398) at the smoke views,
    on JAX's public functions."""
    import jax
    import jax.numpy as jnp
    from joint_tensorf_tpu.data.synthetic import sphere_poses
    from joint_tensorf_tpu.geometry.rays import get_center_and_ray
    from joint_tensorf_tpu.models.alpha_mask import sample_alpha
    from joint_tensorf_tpu.render.renderer import sample_ray

    n_views, H, W = _SMOKE_VIEWS, _SMOKE_H, _SMOKE_W
    aabb = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
    prng = np.random.default_rng(7)
    poses = jnp.asarray(sphere_poses(n_views))
    focal_p = 0.5 * 800 / np.tan(0.5 * 0.6911) * (W / 800)
    intr_p = jnp.asarray(np.broadcast_to(
        np.array([[focal_p, 0, W / 2], [0, focal_p, H / 2], [0, 0, 1]],
                 dtype=np.float32), (n_views, 3, 3)))
    idx = jnp.asarray(prng.permutation(H * W)[:64])
    c, d = get_center_and_ray(H, W, poses, jnp.linalg.inv(intr_p),
                              ray_idx=idx)
    c, d = c.reshape(-1, 3), d.reshape(-1, 3)
    ab = jnp.asarray(np.array(aabb, np.float32).reshape(2, 3))
    units = (ab[1] - ab[0]) / (jnp.asarray(res_p, jnp.float32) - 1)
    step_sz = jnp.mean(units) * 0.5
    g = stride if S % stride == 0 else 1
    pts, _, inb = sample_ray(ab, step_sz, S, c, d, jax.random.PRNGKey(0),
                             2.0, 6.0, stratified=False)
    galive = jnp.any(inb.reshape(inb.shape[0], S // g, g), axis=-1)
    if mask is not None:
        a = sample_alpha(mask, pts[:, ::g].reshape(-1, 3)
                         ).reshape(inb.shape[0], S // g)
        galive = galive & (a > 0)
    mx = int(jnp.max(jnp.sum(galive, axis=-1))) * g
    k = min(S, max(128, int(-(-int(mx * pad) // 128) * 128)))
    return None if k >= S else k


def _jax_six_balls(mres):
    """The root bench's sharp mask of the blur-mask windows
    (bench.py:630-640)."""
    ball_rng = np.random.default_rng(11)
    ax0 = np.linspace(-1.5, 1.5, mres[0], dtype=np.float32)
    ax1 = np.linspace(-1.5, 1.5, mres[1], dtype=np.float32)
    ax2 = np.linspace(-1.5, 1.5, mres[2], dtype=np.float32)
    BX, BY, BZ = np.meshgrid(ax0, ax1, ax2, indexing="ij")
    sharp = np.zeros(tuple(mres), np.float32)
    for _ in range(6):
        cx, cy, cz = ball_rng.uniform(-0.9, 0.9, 3)
        rad = ball_rng.uniform(0.25, 0.45)
        sharp[(BX - cx) ** 2 + (BY - cy) ** 2 + (BZ - cz) ** 2
              < rad * rad] = 1.0
    return sharp


@pytest.mark.parametrize("res, S, radius, want", [
    (48, 256, None, None), (48, 1000, None, 256), (128, 443, None, 384),
    (48, 256, 2, 128), (48, 1000, 6, 256)])
def test_probe_bbox_k_matches_the_root_bench(res, S, radius, want):
    """The in-bbox budget, and under a dilated six-ball mask (pad 1.25)
    the blur-mask window's, equal the root bench's arithmetic on JAX's
    sample_ray, sample_alpha and get_center_and_ray (``want``: what both
    give at the smoke views)."""
    import jax.numpy as jnp
    from joint_tensorf_tpu.models import alpha_mask as jam

    from joint_tensorf_tpu_torch.models import alpha_mask as tam

    res3 = (res, res, res)
    kw = {}
    jax_kw = {}
    if radius is not None:
        sharp = pbench.six_ball_mask([32, 32, 32])
        assert np.array_equal(sharp, _jax_six_balls([32, 32, 32]))
        box = np.array(pbench.AABB, np.float32).reshape(2, 3)
        kw = {"mask": tam.dilate_mask(tam.AlphaMask(
            grid=torch.as_tensor(sharp), aabb=torch.as_tensor(box)), radius),
            "pad": 1.25}
        jax_kw = {"mask": jam.dilate_mask(jam.AlphaMask(
            grid=jnp.asarray(sharp), aabb=jnp.asarray(box)), radius),
            "pad": 1.25}
    got = pbench.probe_bbox_k(res3, S, _SMOKE_VIEWS, _SMOKE_H, _SMOKE_W,
                              torch.device("cpu"), **kw)
    assert got == _jax_probe_bbox_k(res3, S, **jax_kw) == want


def test_phase_setups_make_the_root_bench_choices(smoke):
    """phase_setups(small=True) gives the root bench's steps at its smoke
    shapes (bench.py:456-686), in its order: the compacted step (the
    mask, compact_k min(256, S // 2) = 128, no blur, no dense grid, app_k
    64; the raised caps are 64 there, so no other compacted step), early
    and dense (the blur, the dense grid, app_k 64, the in-bbox budget,
    None at these shapes), and the one blur-mask budget its three windows
    share (radius 2, K 128, as the root bench's smoke run probes).  A
    measurement runs on a copy: the phases' shared state is unchanged."""
    from joint_tensorf_tpu_torch.render.renderer import BlurSpec

    work, phases = smoke
    assert [p.name for p in phases] == [
        "compacted_appk64", "early", "dense", "dense_blur_mask_k128"]
    assert (work.n_views, work.H, work.W, work.res, work.n_samples,
            work.rays_per_view, work.n_rays, work.reps, work.iters) == (
        8, 64, 64, (48, 48, 48), 256, 32, 256, 2, 2)
    blur = BlurSpec("uniform-gaussian", 64)
    want = {  # compact_k, app_k, blur, dense grid, mask
        "compacted_appk64": (128, 64, None, False, True),
        "early": (None, 64, blur, True, False),
        "dense": (None, 64, blur, True, False),
        "dense_blur_mask_k128": (128, 64, blur, True, True)}
    for p in phases:
        got = (p.cfg.compact_k, p.cfg.app_k, p.cfg.blur,
               p.cfg.densify_density, p.mask is not None)
        assert got == want[p.name], p.name
        assert p.cfg.pose_opt and p.cfg.n_samples == 256
    assert work.mask_res == [32, 32, 32] and work.bbox_k is None
    assert phases[0].mask.grid.shape == (32, 32, 32)
    assert [(w["radius_cells"], w["compact_k_blur"], w["phase"])
            for w in work.windows] == [(2, 128, "dense_blur_mask_k128")] * 3
    before = {k: v.clone() for k, v in phases[0].state.field.state_dict()
              .items()}
    m = pbench.measure(work, phases[0], iters=1, reps=1)
    assert m["median_s"] > 0 and (m["reps"], m["iters"]) == (1, 1)
    after = phases[0].state.field.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_phase_steps_scatter_calls_match_expected_launches(monkeypatch,
                                                          smoke):
    """One CPU step of each phase makes the row-scatter calls that
    chip_smoke.expected_launches asks of K3 on the card for its step
    config (6 two-stage compacted, 7 with the dense grid), and the summed
    density samples it asks of K6 (once each way compacted, none with the
    dense grid)."""
    import chip_smoke
    from test_torch_test_optim import _Counter

    work, phases = smoke
    for p in phases:
        count = _Counter(monkeypatch)
        metrics, _ = pbench.run_iter(work, p, copy.deepcopy(p.state))
        assert np.isfinite(float(metrics["loss"]))
        want = chip_smoke.expected_launches(p.cfg)
        masked = p.mask is not None and not p.cfg.densify_density
        assert count.n == want["scatter_add_rows"] == (6 if masked else 7), \
            p.name
        assert count.k6 == count.k6_of(want) == {
            "density_sample_fwd": int(masked),
            "density_sample_bwd": int(masked)}, p.name


# --------------------------------------------------------- the command line
def _run_bench(env_extra, *args):
    """The bench as a user runs it, on one host thread."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JTF_BENCH_SMALL", "CUDA_VISIBLE_DEVICES")}
    env.update(env_extra, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "joint_tensorf_tpu_torch.bench", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_cpu_smoke_mode_prints_one_line_and_writes_no_record(
        monkeypatch, capsys, tmp_path, smoke):
    """main(["--device=cpu"]) in the smoke mode (JTF_BENCH_SMALL=1) on the
    shared smoke phases: returns 0, prints one JSON line with the root
    bench's keys and writes no record."""
    record = tmp_path / "last_bench_torch.json"
    monkeypatch.setattr(pbench, "_SMALL", True)
    monkeypatch.setattr(pbench, "_LAST_GOOD", str(record))

    def setups(small, device):
        assert small and device.type == "cpu"
        return smoke

    monkeypatch.setattr(pbench, "phase_setups", setups)
    assert pbench.main(["--device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert rec["metric"] == "rays_per_sec_train" and rec["value"] > 0
    det = rec["detail"]
    assert det["device"] == "cpu" and "not measurements" in det[
        "device_note"]
    assert det["res"] == [48, 48, 48] and det["n_rays"] == 256
    assert det["roofline_compacted"]["hbm_util"] == "not measured"
    assert [w["compact_k_blur"] for w in det["dense_blur_mask"]["windows"]
            ] == [128] * 3
    assert not record.exists()


@pytest.mark.parametrize("env_extra, args, says", [
    ({"JTF_BENCH_SMALL": "1"}, (), "no CUDA card"),
    ({}, ("--device=cpu",), "runs only the smoke mode")])
def test_refuses_without_a_card(env_extra, args, says):
    """Without --device=cpu on a host without a card it raises; a CPU run
    outside the smoke mode is refused; neither prints a number."""
    if torch.cuda.is_available() and not args:
        pytest.skip("a card is present: the default runs on it")
    out = _run_bench(env_extra, *args)
    assert out.returncode != 0
    assert says in out.stderr
    assert out.stdout.strip() == ""
