"""field_sample_ms: device milliseconds a step under the autograd ranges
of the VM field's samples, forward and backward: the fused and plain
plane x line sample (ops/sampling.py SamplePlaneLineProd, _GatherRows,
the hybrids) and the dense grid's row gather (ops/densify.py
_RowGather)."""

RANGES = ("SamplePlaneLineProd", "_GatherRows", "SamplePlaneHybrid",
          "SampleLineHybrid", "_RowGather")


def read(ctx):
    total = ctx.span.under(RANGES)
    return 1e3 * total / ctx.steps if total > 0 else None
