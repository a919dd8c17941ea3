"""Per-layer metric readers, one module per metric named as in
``BENCHMARK.json``: ``read(obs)`` takes what a traced run observed (the
``obs`` dict of its traffic driver) and returns the metric's value, or
None where there is nothing to read (no device trace, no such kernel)."""
