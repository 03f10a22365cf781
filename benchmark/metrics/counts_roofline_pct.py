"""K2 (``rebuild_counts`` and ``cast_mirror``): its bound over a sweep
(``roofline.py``) as a share of their device time per sweep in the traced
span."""

from benchmark import roofline


def read(ctx):
    t = ctx.trace
    if t is None or ctx.counts is None or not roofline.counts_chain(ctx.config):
        return None
    times = [t.kernel_s(name) for name in ("rebuild_counts", "cast_mirror")]
    if not all(times):
        return None
    return 100.0 * roofline.counts_bound_s(ctx.counts) / (sum(times) / t.sweeps)
