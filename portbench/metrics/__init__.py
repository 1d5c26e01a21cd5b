"""Per-layer metrics, one reader a metric, found by its name in
``BENCHMARK.json``. ``read(reading)`` takes the traced run's
``portbench.trace.Reading`` and returns the value, or None when the
trace holds nothing it reads (the harness then leaves it out)."""
