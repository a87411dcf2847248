"""Share of its roofline of ops/kernels/fused_head_decode.fused_head_decode_v2
(csrc/fused_head_decode.cu), in %: the least time of the launches one batch
routes there (``reference/counts.kernel_bounds``) times the traced batches,
over the device time of the kernels named ``head_kernel`` in the trace."""

from port_bench.reference.counts import kernel_bounds

PATTERN = r"\bhead_kernel\b"


def read(ctx):
    t = ctx.summary.kernel_s(PATTERN)
    if not t:
        return None
    bound = kernel_bounds(ctx.model_cfg, ctx.items_per_unit)["head_decode"] * ctx.summary.units
    return 100.0 * bound / t
