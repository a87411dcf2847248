"""The whole serving call's share of the card's peak, in %: one batch's
forward operations, each at the peak of the type its configuration states
(the int8 entry: every trunk conv but the first in int8, the rest bf16; the
bf16 entry: all bf16), over the traced window's seconds per batch."""

from port_bench.reference.counts import forward_work


def read(ctx):
    s = ctx.summary
    if not s.units or s.window_s <= 0:
        return None
    ideal = forward_work(ctx.model_cfg, ctx.traffic["entry"] == "int8").scaled(
        ctx.items_per_unit).ops_s
    return 100.0 * ideal / (s.window_s / s.units)
