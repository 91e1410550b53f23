"""The attribution of device idle time and host syncs to the program's
spans (benchmark/attribution.py) on hand-made intervals and events, and
the six readers of it (idle_*_ms, host_syncs_per_step, host_sync_wait_ms)
on a trace with and without ``jt.`` ranges."""
import types

import pytest
from torch.autograd import DeviceType

from benchmark import attribution, spec
from benchmark.tests.tiny import ROOT
from benchmark.trace import Span

READERS = ("idle_trainer_ms", "idle_render_ms", "idle_backward_ms",
           "idle_adam_ms", "host_syncs_per_step", "host_sync_wait_ms")


def _event(name, start, end, device=DeviceType.CPU):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=False,
        time_range=types.SimpleNamespace(start=start, end=end))


def _kernel(start, end):
    return _event("kernel", start, end, DeviceType.CUDA)


def _ctx(events, steps=1):
    return types.SimpleNamespace(
        span=Span(window_s=0.0, busy_s=0.0, device_ops=[], idle_gaps=[],
                  events=events), steps=steps)


def test_union_complement_intersect():
    assert attribution.union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) == [
        (0, 3), (5, 8)]
    assert attribution.complement((0, 10), [(2, 3), (-1, 1), (9, 12)]) == [
        (1, 2), (3, 9)]
    assert attribution.complement((0, 10), []) == [(0, 10)]
    assert attribution.intersect([(0, 10)], [(2, 3), (5, 7)]) == 3.0
    assert attribution.intersect([(0, 4), (6, 8)], [(3, 7)]) == 2.0
    assert attribution.intersect([(0, 1)], []) == 0.0


def test_innermost_span():
    spans = [("jt.step", 0, 100), ("jt.render", 10, 50),
             ("jt.render.sample", 10, 20), ("jt.step.backward", 60, 90)]
    assert attribution.innermost(spans, 15) == "jt.render.sample"
    assert attribution.innermost(spans, 30) == "jt.render"
    assert attribution.innermost(spans, 55) == "jt.step"
    assert attribution.innermost(spans, 90) == "jt.step"
    assert attribution.innermost(spans, 150) == "-"


def test_idle_time_is_put_down_by_interval(capsys):
    """Nested spans count once; a gap across two spans is split between
    them; a gap outside every span goes to none."""
    events = [
        _event("bench.window", 0, 100),
        _event("bench.iteration", 0, 100),
        _event("jt.step", 10, 60),
        _event("jt.render", 10, 30), _event("jt.render.sample", 10, 20),
        _event("jt.step.backward", 30, 50),
        _event("jt.trainer.schedule", 0, 10),
        _kernel(0, 5),              # idle 5-12: trainer 5-10, render 10-12
        _kernel(12, 25),            # idle 25-35: render 25-30, backward 30-35
        _kernel(35, 70),            # idle 70-80: outside every span
        _kernel(80, 100),
        # a GPU-side copy of a host range is no device work
        types.SimpleNamespace(
            name="jt.step", device_type=DeviceType.CUDA,
            is_user_annotation=True,
            time_range=types.SimpleNamespace(start=0, end=100)),
    ]
    r = attribution.read(_ctx(events).span)
    assert r.idle == [(5, 12), (25, 35), (70, 80)]

    g = attribution.GROUPS
    assert r.idle_under(g["trainer"]) == 5
    assert r.idle_under(g["render"]) == 7
    assert r.idle_under(g["backward"]) == 5
    assert r.idle_under(lambda n: True) == 17
    ctx = _ctx(events, steps=2)
    assert spec.reader(ROOT, "idle_render_ms")(ctx) == pytest.approx(
        7e-3 / 2)
    assert spec.reader(ROOT, "idle_trainer_ms")(ctx) == pytest.approx(
        5e-3 / 2)
    assert spec.reader(ROOT, "idle_backward_ms")(ctx) == pytest.approx(
        5e-3 / 2)
    assert spec.reader(ROOT, "idle_adam_ms")(ctx) is None   # no such span
    assert ("jt.* 0.0085, outside jt. 0.0050 of 0.0135 (62.96% under jt.)"
            in capsys.readouterr().err)


def test_host_syncs_are_put_down_to_the_innermost_span(capsys):
    events = [
        _event("bench.window", 0, 200),
        _event("bench.iteration", 0, 100), _event("bench.iteration", 100, 190),
        _event("jt.trainer.upload", 5, 15),
        _event("jt.step", 20, 90), _event("jt.render.sample", 30, 40),
        _event("cudaStreamSynchronize", 6, 8),
        _event("cudaStreamSynchronize", 10, 14),
        _event("cudaStreamSynchronize", 32, 33),
        _event("cudaMemcpy", 50, 52),
        _event("cudaMemcpyAsync", 60, 61),          # no sync by itself
        _event("cudaDeviceSynchronize", 195, 199),  # the harness's, outside
        _kernel(0, 200),
    ]
    ctx = _ctx(events, steps=2)
    r = attribution.read(ctx.span)
    assert [s[3] for s in r.syncs] == ["jt.trainer.upload"] * 2 + [
        "jt.render.sample", "jt.step"]
    assert spec.reader(ROOT, "host_syncs_per_step")(ctx) == 2.0
    assert spec.reader(ROOT, "host_sync_wait_ms")(ctx) == pytest.approx(
        1e-3 * 9 / 2)
    err = capsys.readouterr().err
    assert "jt.trainer.upload 1.00 (0.0030 ms)" in err
    assert "jt.render.sample 0.50" in err and "jt.step 0.50" in err


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_program_spans(name, capsys):
    """A program without jt. ranges (the benchmark's parent) reads
    nothing, prints nothing and does not raise."""
    events = [_event("bench.window", 0, 100),
              _event("bench.iteration", 0, 100),
              _event("bench.train_step", 10, 90),
              _event("cudaStreamSynchronize", 20, 30), _kernel(0, 50)]
    assert spec.reader(ROOT, name)(_ctx(events)) is None
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("name", READERS)
def test_readers_are_listed_for_both_cells(name):
    entry = {m["name"]: m for m in spec.load(ROOT)["per_layer"]}[name]
    assert entry["workloads"] == ["bat_blender.masked", "bat_llff.final"]
    assert entry["moves"] == "train_rays_per_s"
    assert entry["better"] == "lower"
