"""The traced window's device idle time and host syncs put down to the
program's own spans (joint_tensorf_tpu_torch/utils/tracing.py: the host
ranges ``jt.*``), by time interval, not by parent chain: autograd runs
the backward's CUDA work on a thread of its own, whose launches have no
``jt.`` parent, while the host thread waits inside ``jt.step.backward``.

- Idle intervals: the complement, inside ``bench.window``, of the union of
  device activity (what trace._on_device counts, as device_idle_share
  does).
- A group of spans' idle time: the idle intervals intersected with the
  union of those spans' host intervals.
- Host syncs: the runtime calls in SYNC_CALLS that start inside a
  ``bench.iteration`` range, each put down to the innermost ``jt.`` range
  open at its start (``-`` for none), with the host time spent in it.

``intersect`` and ``innermost`` are pure functions over interval lists
(microseconds); ``read`` reduces a traced span's events to them once.
"""
from __future__ import annotations

import dataclasses

from torch.autograd import DeviceType

from benchmark.trace import _on_device

PREFIX = "jt."
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# the spans of each idle metric (idle_<group>_ms), by name
GROUPS = {
    "trainer": lambda n: n.startswith("jt.trainer."),
    "render": lambda n: n == "jt.render" or n.startswith("jt.render."),
    "backward": lambda n: n == "jt.step.backward",
    "adam": lambda n: n == "jt.step.adam",
}


def union(intervals) -> list:
    """Sorted disjoint [start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def complement(window, intervals) -> list:
    """The parts of ``window`` (start, end) that no interval covers."""
    w0, w1 = window
    out, t = [], w0
    for s, e in union(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def intersect(a, b) -> float:
    """Length of the intersection of two interval lists."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans, t: float) -> str:
    """The name of the shortest span (name, start, end) open at ``t``;
    ``-`` when none is."""
    best, length = "-", None
    for name, s, e in spans:
        if s <= t < e and (length is None or e - s < length):
            best, length = name, e - s
    return best


@dataclasses.dataclass
class Reading:
    idle: list       # [(start, end)] us: device idle inside the window
    spans: list      # [(name, start, end)] us: the host ranges jt.*
    syncs: list      # [(call, start, end, innermost jt. span)] us

    def idle_under(self, match) -> float:
        """Idle microseconds under the union of the spans whose name
        ``match`` accepts."""
        return intersect(self.idle, [(s, e) for n, s, e in self.spans
                                     if match(n)])


_last = [None, None]


def read(span):
    """The Reading of a traced span (trace.Span), or None when its events
    hold no ``jt.`` range (a program without the spans)."""
    if _last[0] is span:
        return _last[1]
    window, iterations, spans, device, calls = None, [], [], [], []
    for e in span.events:
        tr = e.time_range
        if _on_device(e):
            device.append((tr.start, tr.end))
        elif e.device_type != DeviceType.CPU:
            continue
        elif e.name.startswith(PREFIX):
            spans.append((e.name, tr.start, tr.end))
        elif e.name == "bench.window":
            window = (tr.start, tr.end)
        elif e.name == "bench.iteration":
            iterations.append((tr.start, tr.end))
        elif e.name in SYNC_CALLS:
            calls.append((e.name, tr.start, tr.end))
    out = None
    if spans and window is not None:
        syncs = [(n, s, t, innermost(spans, s)) for n, s, t in calls
                 if any(a <= s < b for a, b in iterations)]
        out = Reading(idle=complement(window, device), spans=spans,
                      syncs=syncs)
    _last[0], _last[1] = span, out
    return out


def idle_ms(ctx, group: str):
    """Idle milliseconds a traced step under the spans of GROUPS[group];
    None without them."""
    r, match = read(ctx.span), GROUPS[group]
    if r is None or ctx.steps == 0 or not any(match(n)
                                              for n, _, _ in r.spans):
        return None
    return 1e-3 * r.idle_under(match) / ctx.steps


def idle_split(ctx) -> str:
    """One line: the idle milliseconds a traced step under each group,
    under any ``jt.`` span and outside every one."""
    r = read(ctx.span)
    ms = {k: 1e-3 * r.idle_under(m) / ctx.steps for k, m in GROUPS.items()}
    under = 1e-3 * r.idle_under(lambda n: True) / ctx.steps
    total = 1e-3 * sum(e - s for s, e in r.idle) / ctx.steps
    return ("[bench] idle ms a step by span: "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + f", jt.* {under:.4f}, outside jt. {total - under:.4f} of "
            f"{total:.4f} ({100.0 * under / total if total else 0.0:.2f}% "
            f"under jt.)")
