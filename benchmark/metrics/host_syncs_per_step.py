"""host_syncs_per_step: the synchronising runtime calls
(cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize,
blocking cudaMemcpy) that start inside a bench.iteration range, per traced
iteration (benchmark/attribution.py).  Prints on standard error one line
with each innermost jt. span's syncs and host wait a step."""
import sys

from benchmark import attribution


def read(ctx):
    r = attribution.read(ctx.span)
    if r is None or ctx.steps == 0:
        return None
    by = {}
    for _, s, e, name in r.syncs:
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + e - s)
    print("[bench] host syncs a step by span: " + (", ".join(
        f"{k} {n / ctx.steps:.2f} ({1e-3 * us / ctx.steps:.4f} ms)"
        for k, (n, us) in sorted(by.items())) or "none"),
        file=sys.stderr, flush=True)
    return len(r.syncs) / ctx.steps
