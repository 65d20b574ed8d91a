"""Benchmark of composablestatespacemodels_torch on NVIDIA H100 cards.

A cell of ``BENCHMARK.json`` runs as

    python3 -m cssm_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``run.py``).  Configurations, traffic mixes,
drivers and metrics are files found by name (``cell.py``); the plain
reference the check holds the port against is ``reference/``;
``python3 -m cssm_bench.calibrate`` reads on the card what a check's
limits are set from.  The CPU tests: ``python -m pytest cssm_bench/tests
-p no:cacheprovider``.
"""
