"""Metric readers, one file per metric, named as in ``BENCHMARK.json``.

Each module gives ``read(ctx) -> float | None`` over a ``harness.Context``;
``None`` means it found nothing to read, and the metric is left out of
the result's line.
"""
