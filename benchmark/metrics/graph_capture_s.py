"""Seconds of the sweep graph's capture and instantiation
(``ops/graphs.capture_graph``, summed over the graphs captured): the
program's span ``graph.capture``, read from its recorder."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "span_seconds", None)
    return reader("graph.capture") if reader is not None else None
