"""Bytes of the per-token arrays that every WarpLDA sweep reads besides
the tables and the uniforms (words, documents, mask, the document's and
the word's first slots and sizes, the word-major order): the program's
counter ``warp.arg_bytes``, read from its recorder; ``None`` where it
counted none."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "counters", None)
    counted = reader() if reader is not None else {}
    return counted.get("warp.arg_bytes")
