"""trainer_host_ms: host milliseconds an iteration spends in the Trainer
outside its step (host schedule, ray draws, probes, 2D blur caches, the
schedule update), from the benchmark's spans: the iteration's span minus
the span around Trainer._step, averaged over the traced iterations."""


def read(ctx):
    n = min(len(ctx.iter_s), len(ctx.step_s))
    if n == 0:
        return None
    return 1e3 * sum(i - s for i, s in zip(ctx.iter_s[:n],
                                           ctx.step_s[:n])) / n
