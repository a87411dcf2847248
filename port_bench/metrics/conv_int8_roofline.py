"""Share of its roofline of ops/kernels/conv_int8 (csrc/conv_int8.cu), every
W8A8 site but layer1's, in %: the least time of the launches one batch
routes there (``reference/counts.kernel_bounds``) times the traced batches,
over the device time of the kernels named ``conv_int8_kernel`` in the trace."""

from port_bench.reference.counts import kernel_bounds

PATTERN = r"\bconv_int8_kernel\b"


def read(ctx):
    t = ctx.summary.kernel_s(PATTERN)
    if not t:
        return None
    bound = kernel_bounds(ctx.model_cfg, ctx.items_per_unit)["conv_int8"] * ctx.summary.units
    return 100.0 * bound / t
