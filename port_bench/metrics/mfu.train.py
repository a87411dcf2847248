"""The whole train step's share of the card's bf16 peak, in %: three times
the forward's operations (forward and backward) times the batch, over the
traced window's seconds per step."""

from port_bench.reference.counts import PEAK_BF16, train_step_flops


def read(ctx):
    s = ctx.summary
    if not s.units or s.window_s <= 0:
        return None
    return 100.0 * train_step_flops(ctx.model_cfg, ctx.items_per_unit) / PEAK_BF16 / (
        s.window_s / s.units)
