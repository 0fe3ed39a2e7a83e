"""One reader a metric, found by the metric's name in BENCHMARK.json:
``read(run)`` takes the harness's ``Run`` and returns the value, or None
where the run holds nothing to read (the metric is then left out)."""
