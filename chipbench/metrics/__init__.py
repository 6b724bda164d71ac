"""Per-layer metrics, one module a metric, named as in ``BENCHMARK.json``:
``read(ctx)`` returns the value, or None where the run holds nothing to
read it from."""
