"""Share of its roofline of ops/kernels/fused_bottleneck.fused_basic_chain
(csrc/basic_chain.cu), in %: the least time of the launches one batch routes
there (``reference/counts.kernel_bounds``) times the traced batches, over
the device time of the kernels named ``basic_block_kernel`` in the trace."""

from port_bench.reference.counts import kernel_bounds

PATTERN = r"\bbasic_block_kernel\b"


def read(ctx):
    t = ctx.summary.kernel_s(PATTERN)
    if not t:
        return None
    bound = kernel_bounds(ctx.model_cfg, ctx.items_per_unit)["basic_chain"] * ctx.summary.units
    return 100.0 * bound / t
