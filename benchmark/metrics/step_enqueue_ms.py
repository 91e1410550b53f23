"""step_enqueue_ms: host milliseconds inside Trainer._step (train/step.py:
the step's graph, autograd, Adam) per iteration, from the benchmark's span
around it.  A wait for the device inside the call shows here too."""


def read(ctx):
    if not ctx.step_s:
        return None
    return 1e3 * sum(ctx.step_s) / len(ctx.step_s)
