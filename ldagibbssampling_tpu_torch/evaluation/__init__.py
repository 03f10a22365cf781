"""Evaluation: tracing, timing and metrics logging."""
