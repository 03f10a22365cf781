"""Seconds of WarpLDA's word-major order of the tokens (``backends/warp.
word_csr``: the host's stable sort of every token by word, the word
pointers): the program's span ``warp.word_csr``, read from its recorder."""


def read(ctx):
    from ldagibbssampling_tpu_torch.evaluation import tracing

    reader = getattr(tracing, "span_seconds", None)
    return reader("warp.word_csr") if reader is not None else None
