"""k3_roofline: K3's share of its roofline, in percent: the least time the
row scatter of the factor gradients could take a step (the model's census,
``k3_floor_s``, for BAT census/counts.py, from the samples the step needs;
the dense-grid form where the trace shows the dense grid's row gather) over
the device time of K3's kernels (csrc/segment_scatter.cu
scatter_add_rows_*) a step."""


def read(ctx):
    k3 = ctx.span.kernels("scatter_add_rows") / ctx.steps
    if k3 <= 0:
        return None
    floor = ctx.census.k3_floor_s(ctx.shape,
                                  ctx.span.has_range("_RowGather"))
    return 100.0 * floor / k3
