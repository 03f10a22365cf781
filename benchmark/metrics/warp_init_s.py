"""Seconds of ``WarpModel``'s construction (the initial state, the host's
word sort, the per-token arrays, the graph's buffers), the card waited
for: the program's span ``warp.init``, read from its recorder."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "span_seconds", None)
    return reader("warp.init") if reader is not None else None
