"""Bytes the sweep graph clones and hands back per sweep (``ops/graphs.
SweepGraph.__call__``: every buffer, the padded ones whole): the program's
counters ``graph.handout_bytes`` over ``graph.replays``, read from its
recorder; ``None`` where no replay was counted."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "counters", None)
    counted = reader() if reader is not None else {}
    replays, handed = counted.get("graph.replays"), counted.get("graph.handout_bytes")
    if not replays or handed is None:
        return None
    return handed / replays
