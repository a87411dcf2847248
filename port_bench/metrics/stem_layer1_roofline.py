"""Share of its roofline of ops/kernels/fused_bottleneck.fused_stem_layer1
(csrc/stem_layer1.cu and csrc/fused_bottleneck.cu), in %: the least time of
the launches one batch routes there (``reference/counts.kernel_bounds``)
times the traced batches, over the device time of the kernels named
``stem_s2d_kernel|bottleneck_kernel`` in the trace."""

from port_bench.reference.counts import kernel_bounds

PATTERN = r"\bstem_s2d_kernel\b|\bbottleneck_kernel\b"


def read(ctx):
    t = ctx.summary.kernel_s(PATTERN)
    if not t:
        return None
    bound = kernel_bounds(ctx.model_cfg, ctx.items_per_unit)["stem_layer1"] * ctx.summary.units
    return 100.0 * bound / t
