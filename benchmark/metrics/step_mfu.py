"""step_mfu: the whole step's share of one H100's peak, in percent: the
least time the step could take (the model's census, ``step_floor_s``:
float32 operations over 67 TFLOP/s or bytes over 3.35 TB/s, whichever is
longer, counted from the cell's shapes and the samples its inputs need;
for BAT census/counts.py) over the traced window's mean step time."""


def read(ctx):
    if ctx.steps == 0 or ctx.span.window_s <= 0:
        return None
    return 100.0 * ctx.census.step_floor_s(ctx.shape) / (
        ctx.span.window_s / ctx.steps)
