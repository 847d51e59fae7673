"""Metric readers: `<name>.py` for each metric of BENCHMARK.json.

Each defines `read(ctx)` and returns the metric's value, or None where it
finds nothing to read (the harness then leaves the metric out).  `ctx`
(benchmark/run.py) holds the cell, its configuration and traffic, the
window (`latencies_s`, `epochs`, `window_s`, `setup_s`,
`contributions_per_epoch`) and, in a traced run, the profiler's
`device_events` and outermost `host_events` (yardstick/trace.Event, in
microseconds) and `busy_s`.
"""
