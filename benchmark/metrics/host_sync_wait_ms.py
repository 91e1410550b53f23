"""host_sync_wait_ms: host milliseconds a traced iteration spends inside
the synchronising runtime calls host_syncs_per_step counts
(benchmark/attribution.py)."""
from benchmark import attribution


def read(ctx):
    r = attribution.read(ctx.span)
    if r is None or ctx.steps == 0:
        return None
    return 1e-3 * sum(e - s for _, s, e, _ in r.syncs) / ctx.steps
