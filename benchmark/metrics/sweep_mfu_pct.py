"""The whole sweep's share of the card's float32 peak: a sweep's operations
(``roofline.sweep_ops``) over its wall time in the traced span."""

from benchmark import roofline


def read(ctx):
    t = ctx.trace
    if (t is None or ctx.counts is None or t.sweeps <= 0
            or not roofline.counts_chain(ctx.config)):
        return None
    per_sweep = t.window_s / t.sweeps
    return 100.0 * roofline.sweep_ops(ctx.counts) / (per_sweep * roofline.F32_OPS_PER_S)
