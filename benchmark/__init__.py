"""The benchmark of `hydrabadger_tpu_torch`: one cell of BENCHMARK.json run once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the yardstick needs lives here and imports nothing of the
program: the plain references (`reference/`), the peaks, work models and
profiler arithmetic (`yardstick/`), the configurations (`configs/`), the
traffic mixes (`workloads/`), one driver per system path (`drivers/`) and
one reader per metric (`metrics/`).  The harness finds each by the name
BENCHMARK.json gives it.
"""
