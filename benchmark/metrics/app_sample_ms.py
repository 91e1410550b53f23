"""app_sample_ms: device milliseconds a step under the autograd ranges of
the VM field's concatenated appearance sample, forward and backward
(ops/sampling.py SamplePlaneLineProdCat: kernel K7 on the card).  A
program without that sample has no such range: nothing to read."""

RANGES = ("SamplePlaneLineProdCat",)


def read(ctx):
    total = ctx.span.under(RANGES)
    return 1e3 * total / ctx.steps if total > 0 else None
