"""The benchmark ladder on the port's own models (``benchmarks/ladder.py``)."""
