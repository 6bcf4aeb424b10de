"""The benchmark of tpusparse_torch: one run of one cell per process.

``python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. The cells, configurations, traffic mixes and metrics are
named in ``BENCHMARK.json`` at the root and found by name under this folder:
``configs/<config>.json`` (sizes) with ``configs/<config>.py`` (its driver)
and ``reference/<config>.py`` (its plain reference),
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.
"""
