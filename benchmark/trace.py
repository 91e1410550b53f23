"""Reduction of a traced span (torch.profiler) to the device's busy time,
its idle gaps, the device time under named host ranges and by kernel name.

Every device activity (kernel, memcpy, memset) counts as busy, but not
the profiler's GPU-side copies of host ranges (user annotations, such as
``bench.train_step``), which span whole steps; the window
is the host range ``bench.window``, which opens and closes on a
synchronise.  Device time under a host range is the sum over the
outermost host events whose name holds one of the patterns of the device
time of the kernels launched inside them (FunctionEvent.device_time_total,
children included)."""
from __future__ import annotations

import dataclasses

import numpy as np
from torch.autograd import DeviceType

N_NAMED_GAPS = 200      # the longest gaps named by the host's work


def _device_total_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


@dataclasses.dataclass
class Span:
    window_s: float                 # the traced window's length
    busy_s: float                   # union of device activity inside it
    device_ops: list                # [[name, seconds], ...] top 10
    idle_gaps: list                 # [[host span, seconds], ...] top 10
    events: list                    # the profiler's FunctionEvents

    def under(self, patterns) -> float:
        """Seconds of device time under the outermost host events whose
        name holds one of ``patterns``."""
        total = 0.0
        for e in self.events:
            if e.device_type != DeviceType.CPU or not _match(e.name,
                                                             patterns):
                continue
            parent, nested = e.cpu_parent, False
            while parent is not None:
                if _match(parent.name, patterns):
                    nested = True
                    break
                parent = parent.cpu_parent
            if not nested:
                total += _device_total_us(e) * 1e-6
        return total

    def has_range(self, pattern: str) -> bool:
        return any(e.device_type == DeviceType.CPU and pattern in e.name
                   for e in self.events)

    def kernels(self, pattern: str) -> float:
        """Seconds of device kernels whose name holds ``pattern``."""
        return sum(e.time_range.elapsed_us() for e in self.events
                   if _on_device(e) and pattern in e.name) * 1e-6


def _on_device(e) -> bool:
    """A device activity: kernel, copy or fill, not an annotation."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def _match(name: str, patterns) -> bool:
    return any(p in name for p in patterns)


def reduce(prof) -> Span:
    events = list(prof.events())
    win = [e for e in events if e.name == "bench.window"
           and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1),
                  e.name) for e in events
                 if _on_device(e)
                 and e.time_range.end > w0 and e.time_range.start < w1)
    busy, gaps, by_name = 0.0, [], {}
    cur_s = cur_e = None
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gaps.append((w0 if cur_e is None else cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.time_range.start >= w0 and e.time_range.end <= w1
            and e.name != "bench.window"]
    starts = np.array([e.time_range.start for e in host], np.float64)
    ends = np.array([e.time_range.end for e in host], np.float64)
    names = [e.name for e in host]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])
    by_span = {}
    for i, (g0, g1) in enumerate(gaps):
        name = (_host_doing(starts, ends, names, g0) if i < N_NAMED_GAPS
                else "shorter gaps")
        by_span[name] = by_span.get(name, 0.0) + (g1 - g0)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    return Span(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                device_ops=[[n, v * 1e-6] for n, v in top_ops],
                idle_gaps=[[n, v * 1e-6] for n, v in top_gaps],
                events=events)


def _host_doing(starts, ends, names, t) -> str:
    """'<innermost bench span>/<innermost host op>' open at time ``t``."""
    idx = np.nonzero((starts <= t) & (ends > t))[0]
    bench = [i for i in idx if names[i].startswith("bench.")]
    ops = [i for i in idx if not names[i].startswith("bench.")]

    def inner(ix):
        return names[min(ix, key=lambda i: ends[i] - starts[i])]

    return (f"{inner(bench) if bench else 'bench.window'}/"
            f"{inner(ops) if ops else 'python'}")
