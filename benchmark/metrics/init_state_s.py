"""Seconds of the initial state (``models/state.init_state``: the host draw
of the topics, the copies to the card, the count tables), the card waited
for: the program's span ``state.init``, read from its recorder."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "span_seconds", None)
    return reader("state.init") if reader is not None else None
