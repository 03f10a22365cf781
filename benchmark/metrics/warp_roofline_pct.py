"""The WarpLDA sweep (``backends/warp._warp_sweep_``, every kernel of a
replay and the handout's clones): its least bytes over a sweep
(``roofline_warp.py``) at the memory's rate, as a share of the traced
span's busy device seconds per sweep."""

from benchmark import roofline_warp


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or not t.busy_s or not isinstance(c, roofline_warp.SweepCounts):
        return None
    return 100.0 * roofline_warp.sweep_bound_s(c) / (t.busy_s / t.sweeps)
