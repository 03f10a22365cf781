"""Seconds of the sweep function's construction (``ops/gibbs.make_sweep_fn``:
the host token arrays, the length guard, the copies to the card), the card
waited for: the program's span ``sweep_fn.build``, read from its recorder."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "span_seconds", None)
    return reader("sweep_fn.build") if reader is not None else None
