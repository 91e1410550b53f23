"""k7_kernel_ms: device milliseconds a step in K7's kernels, forward and
backward (csrc/app_sample.cu ``app_fwd_kernel``, ``app_bwd_kernel``),
found by kernel name.  app_sample_ms reads the autograd range around
them, which a step replayed from a CUDA graph has not; the kernels' names
are in every step's trace.  The zeroing of the gradients before the
backward (a memset) is not counted.  A program without K7 on the cell's
path has nothing to read."""

KERNELS = ("app_fwd_kernel", "app_bwd_kernel")


def read(ctx):
    total = sum(ctx.span.kernels(k) for k in KERNELS)
    return 1e3 * total / ctx.steps if total > 0 else None
