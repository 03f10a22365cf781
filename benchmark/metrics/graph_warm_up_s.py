"""Seconds of the sweep graph's eager warm-up sweep before its capture
(``ops/graphs.capture_graph``, the first sweep's call; a kernel library's
first load falls in it), the card waited for: the program's span
``graph.warm_up``, read from its recorder."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "span_seconds", None)
    return reader("graph.warm_up") if reader is not None else None
