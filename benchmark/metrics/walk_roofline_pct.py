"""K1's walk (``gibbs_walk``): its bound over a sweep (``roofline.py``) as a
share of its device time per sweep in the traced span."""

from benchmark import roofline


def read(ctx):
    t = ctx.trace
    walk_s = None if t is None else t.kernel_s("gibbs_walk")
    if not walk_s or ctx.counts is None or not roofline.counts_chain(ctx.config):
        return None
    return 100.0 * roofline.walk_bound_s(ctx.counts) / (walk_s / t.sweeps)
