"""mlp_gemm_ms: device milliseconds a step in the kernels of the matrix
products, whose names hold ``gemm``, with cuBLAS's split-K reductions
(``splitKreduce``), which finish some of them: on a BARF cell the
coordinate MLP's products, forward and backward (models/nerf_mlp.py
apply_nerf_mlp, float32 with TF32 off)."""

KERNELS = ("gemm", "splitKreduce")


def read(ctx):
    total = sum(ctx.span.kernels(k) for k in KERNELS)
    return 1e3 * total / ctx.steps if total > 0 else None
