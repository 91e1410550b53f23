"""The census against hand counts at tiny shapes."""
import pytest

from benchmark.census import counts
from benchmark.census.frozen import (H100_F32_FLOP_PER_SEC,
                                     H100_HBM_BYTES_PER_SEC,
                                     roofline_compacted)

SHAPE = counts.StepShape(
    n_rays=2, n_valid=10, n_gated=4, density_ranks=(1, 1, 1),
    app_ranks=(2, 2, 2), app_dim=3, head_layers=((5, 4), (4, 3)),
    planes=((3, 3),) * 3, lines=(3, 3, 3), n_params=100)


def test_step_flops_by_hand():
    density = 3 * 14 * 1                       # 42 a live sample
    app = 3 * 14 * 2 + 2 * 6 * 3 + 2 * (5 * 4 + 4 * 3)     # 84+36+64
    want = 3 * (10 * (density + 10) + 4 * app) + 12 * 100
    assert counts.step_flops(SHAPE) == want


def test_blur_flops_by_hand():
    s = counts.StepShape(**{**SHAPE.__dict__, "blur_taps": (5, 7)})
    dens = 3 * (2 * 3 * 3 * 1 + 3 * 1)          # 2 passes a plane + a line
    app = 3 * (2 * 3 * 3 * 2 + 3 * 2)
    assert counts.step_flops(s) - counts.step_flops(SHAPE) == \
        4 * (5 * dens + 7 * app)


def test_step_floor_is_the_larger_bound():
    assert counts.step_bytes(SHAPE) == 24 * 100 + 2 * 4 * 4
    assert counts.step_floor_s(SHAPE) == pytest.approx(max(
        counts.step_flops(SHAPE) / H100_F32_FLOP_PER_SEC,
        counts.step_bytes(SHAPE) / H100_HBM_BYTES_PER_SEC))


@pytest.mark.parametrize("dense", [False, True])
def test_k3_floor_by_hand(dense):
    if dense:
        rows, floats = 10, 80
    else:
        rows, floats = 60, 10 * 18
    rows += 24
    floats += 4 * 36
    assert counts.k3_floor_s(SHAPE, dense) == pytest.approx(
        (4 * floats + 4 * rows) / H100_HBM_BYTES_PER_SEC)


def test_frozen_roofline_as_the_bench_printed_it():
    """PR 17's bench printed a byte floor of 1.071 ms and a float32 floor
    of 0.611 ms at 2000 rays, K 256, app_k 192, S 1000, 400^3."""
    r = roofline_compacted(2000, 256, 192, 1000, 400, None, "test")
    assert r["t_hbm_floor_ms"] == pytest.approx(1.071, abs=5e-4)
    assert r["t_f32_flop_floor_ms"] == pytest.approx(0.611, abs=5e-4)
