"""Seconds of the deferred layout's planner (``ops/count_kernel.plan_deferred``,
the host C++ library, inside ``LdaModel``'s ``resolve_tier``): the program's
span ``plan.deferred``, read from its recorder."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "span_seconds", None)
    return reader("plan.deferred") if reader is not None else None
