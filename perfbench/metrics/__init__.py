"""One reader per metric of ``BENCHMARK.json``: ``read(rec)`` takes the
run's record (``perfbench.core.harness.Record``) and returns the metric's
value, or ``None`` where the run has nothing to read for it."""
