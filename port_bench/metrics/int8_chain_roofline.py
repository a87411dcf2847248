"""Share of its roofline of ops/kernels/int8_chain (csrc/int8_chain.cu),
layer1's W8A8 bottlenecks, in %: the least time of the launches one batch
routes there (``reference/counts.kernel_bounds``) times the traced batches,
over the device time of the kernels named ``bottleneck_int8_kernel`` in the
trace."""

from port_bench.reference.counts import kernel_bounds

PATTERN = r"\bbottleneck_int8_kernel\b"


def read(ctx):
    t = ctx.summary.kernel_s(PATTERN)
    if not t:
        return None
    bound = kernel_bounds(ctx.model_cfg, ctx.items_per_unit)["int8_chain"] * ctx.summary.units
    return 100.0 * bound / t
