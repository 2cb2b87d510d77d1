"""Metric readers, one module a metric of BENCHMARK.json: ``read(run)``
returns the metric's number from a :class:`benchmark.harness.Run`, or None
when the run holds nothing to read it from."""
