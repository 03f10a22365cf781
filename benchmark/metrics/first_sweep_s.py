"""Seconds of the first ``sweep(1)`` (the snapshot's cast, the graph's
capture and instantiation, the sweep), the card waited for, on the host's
clock."""


def read(ctx):
    return ctx.host.get("first_sweep_s")
