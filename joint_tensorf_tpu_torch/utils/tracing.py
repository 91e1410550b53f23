"""The port's spans and its host-sync counter.

``span(name)`` marks one part of the program as the profiler range
``jt.<name>``.  The spans sit at the boundaries of the trainer
(``jt.trainer.*``, train/trainer.py), the step (``jt.step`` and
``jt.step.*``, train/step.py and train/l2g.py) and the renderer
(``jt.render`` and ``jt.render.*``, render/renderer.py).  A span is on
while ``torch.profiler`` records (``--profiling=true`` on the train CLI,
utils/logging.profile_trace, or any profiler a caller opens) or while
``count_syncs`` runs: it then opens ``record_function``, so the range
lands in the profiler's own trace on the clock of the device's activity,
nested in the spans open around it, and it names itself on a stack that
``count_syncs`` reads.  Otherwise ``span`` returns one shared no-op
context: 0.69 us a ``with`` block on the host of an H100 machine, where a
bare ``record_function`` costs 13.4 us even with no profiler.  Nothing is
stored or written here: the profiler keeps the ranges and exports them.
``spanned(name)`` puts a whole function inside ``span(name)``.

``count_syncs`` counts the synchronising CUDA calls of a callable (the
warnings of sync debug mode "warn") and puts each down to its source line
and to the innermost span open when it was made.
"""
from __future__ import annotations

import contextlib
import functools
import os
import warnings

import torch
from torch.profiler import record_function

PREFIX = "jt."
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_on = False             # spans on without a profiler (count_syncs)
STACK: list = []        # the names of the open spans, innermost last


class _Span:
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        STACK.append(self.name)
        return self

    def __exit__(self, *exc):
        STACK.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """The range ``jt.<name>`` around a ``with`` block when a profiler
    records or count_syncs runs; else one shared no-op context."""
    if _on or _profiling():
        return _Span(PREFIX + name)
    return _OFF


def spanned(name: str):
    """A decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count_syncs(fn, n_steps: int, where: dict = None,
                by_span: dict = None) -> list:
    """Synchronising CUDA calls of each of ``n_steps`` calls of ``fn``,
    counted as the warnings of torch's sync debug mode "warn" with the
    spans on; ``where`` collects how many came from each source line
    (``file:line`` of the Python call that synchronised, relative to the
    repository's root), ``by_span`` how many from each pair of the
    innermost open span and that line (``"jt.<name> file:line"``, ``-``
    for no span).  Without a card nothing can synchronise it: the counts
    are zeros and the sync debug mode is not touched."""
    global _on
    cuda = torch.cuda.is_available()
    counts, seen = [], []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            seen.append((f"{os.path.relpath(filename, ROOT)}:{lineno}",
                         STACK[-1] if STACK else "-"))

    before, _on = _on, True
    try:
        for _ in range(n_steps):
            seen.clear()
            if cuda:
                torch.cuda.synchronize()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                if cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode("default")
            counts.append(len(seen))
            for site, name in seen:
                if where is not None:
                    where[site] = where.get(site, 0) + 1
                if by_span is not None:
                    key = f"{name} {site}"
                    by_span[key] = by_span.get(key, 0) + 1
    finally:
        _on = before
    return counts
