"""pointwise_ms_per_step.train: device ms per train step of PyTorch's
elementwise, copy, reduction and normalisation kernels (kernel group
pointwise: phi's fp32 passes, casts, LayerNorm, GELU, the loss's softmax)."""

GROUPS = ("pointwise",)


def read(trace, run):
    measured = trace.group_s(*GROUPS)
    if trace.steps == 0 or measured <= 0:
        return None
    return 1e3 * measured / trace.steps
