"""step_graph_share (metrics/step_graph_share.py) on hand-made traces: the
``jt.step.graph`` ranges over the traced steps, nothing to read without
them (the parent of the program that added the range), and its entry in
BENCHMARK.json; k6_kernel_ms and k7_kernel_ms, K6's and K7's kernels by
name (so on replayed steps too), and theirs."""
import types

import pytest
from torch.autograd import DeviceType

from benchmark import spec
from benchmark.tests.tiny import ROOT
from benchmark.trace import Span


def _ctx(names, steps):
    events = [types.SimpleNamespace(name=n, device_type=DeviceType.CPU)
              for n in names]
    events.append(types.SimpleNamespace(name="jt.step.graph",
                                        device_type=DeviceType.CUDA))
    return types.SimpleNamespace(
        span=Span(window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[],
                  events=events), steps=steps)


def test_the_share_counts_the_replayed_steps():
    read = spec.reader(ROOT, "step_graph_share")
    names = ["bench.window"] + ["jt.step", "jt.step.graph"] * 3 + [
        "jt.step", "jt.step.backward"]
    assert read(_ctx(names, 4)) == 75.0
    assert read(_ctx(["bench.window", "jt.step", "jt.step.backward"],
                     4)) is None
    assert read(_ctx(["jt.step.graph"], 0)) is None


def test_the_share_is_listed_for_both_bat_cells():
    entry = {m["name"]: m for m in spec.load(ROOT)["per_layer"]}[
        "step_graph_share"]
    assert entry["workloads"] == ["bat_blender.masked", "bat_llff.final"]
    assert entry["moves"] == "train_rays_per_s"
    assert (entry["unit"], entry["better"]) == ("%", "higher")


def _kernel(name, us):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA, is_user_annotation=False,
        time_range=types.SimpleNamespace(elapsed_us=lambda: us))


@pytest.mark.parametrize("metric,fwd,bwd", [
    ("k6_kernel_ms", "density_fwd_kernel", "density_bwd_kernel"),
    ("k7_kernel_ms", "app_fwd_kernel", "app_bwd_kernel")])
def test_the_kernel_times_read_by_name(metric, fwd, bwd):
    read = spec.reader(ROOT, metric)
    other = [_kernel("void (anonymous namespace)::composite_fwd_kernel<8>("
                     "Params)", 500.0),
             _kernel("Memset (Device)", 70.0),
             types.SimpleNamespace(name=fwd, device_type=DeviceType.CPU)]
    kernels = [_kernel(f"void (anonymous namespace)::{fwd}<4>(Params)",
                       60.0),
               _kernel(f"void (anonymous namespace)::{bwd}<4, true>(Params)",
                       240.0)] * 2
    span = Span(window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[],
                events=other + kernels)
    assert read(types.SimpleNamespace(span=span, steps=2)) == \
        pytest.approx(0.3)
    span.events = other
    assert read(types.SimpleNamespace(span=span, steps=2)) is None
    entry = {m["name"]: m for m in spec.load(ROOT)["per_layer"]}[metric]
    assert entry["workloads"] == ["bat_blender.masked", "bat_llff.final"]
    assert (entry["unit"], entry["better"], entry["source"]) == (
        "ms", "lower", "device_trace")
