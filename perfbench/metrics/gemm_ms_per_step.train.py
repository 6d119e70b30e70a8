"""gemm_ms_per_step.train: device ms per train step of the cuBLAS products
(kernel group gemm: the bf16 GEMMs and phi's fp32 projection x @ Omega)."""

GROUPS = ("gemm",)


def read(trace, run):
    measured = trace.group_s(*GROUPS)
    if trace.steps == 0 or measured <= 0:
        return None
    return 1e3 * measured / trace.steps
