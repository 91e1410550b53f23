"""mlp_roofline: the MLP's matrix products' share of their roofline, in
percent: the least time one H100 could take for them (the model's census,
``mlp_floor_s``, for BARF census/barf_counts.py) over the device time a
step of the kernels mlp_gemm_ms reads."""
from benchmark.metrics import mlp_gemm_ms


def read(ctx):
    ms = mlp_gemm_ms.read(ctx)
    if ms is None:
        return None
    return 100.0 * ctx.census.mlp_floor_s(ctx.shape) / (1e-3 * ms)
