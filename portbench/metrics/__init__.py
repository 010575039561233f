"""Per-layer metrics, one reader a file.

``portbench/metrics/<name>.py`` holds ``read(run)`` for the per-layer
metric ``<name>`` of ``BENCHMARK.json``; ``run`` is the traced run's
:class:`portbench.harness.TracedRun` (the trace, the steps traced, the
program's counters and spans, and the yardstick's bounds).  A reader returns one
number, or None when it finds nothing to read; the harness then leaves
the metric out of the result line.
"""
