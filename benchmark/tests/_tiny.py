"""A cell small enough for the CPU: the traffic of ``gibbs.json`` over a
corpus of a few thousand tokens, with the limits of the NYTimes cell."""

from benchmark import spec

TINY_CONFIG = {
    "name": "tiny", "num_docs": 40, "vocab_size": 700, "num_tokens": 5000,
    "topic_num": 12, "alpha": 0.5, "beta": 0.1,
    "kernel_compute_dtype": "float32", "mirror_dtype": "bfloat16",
    "zipf_s": 1.0, "clump": 1.3, "doc_len_sigma": 0.5,
}


def tiny_cell(**traffic) -> spec.Cell:
    t = spec.load_json(spec.HERE / "traffic" / "gibbs.json")
    t.update({"block_size": 512, "check_tokens": 1 << 20, **traffic})
    limits = spec.load_json(spec.HERE / "limits" / "nytimes-k100.gibbs.json")
    return spec.Cell(name="tiny.gibbs", chips=1, config=dict(TINY_CONFIG),
                     traffic=t, limits=limits, end_to_end=[], per_layer=[])
