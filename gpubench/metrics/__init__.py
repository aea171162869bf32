"""Metrics, one reader a file: ``<metric name>.py`` with ``read(ctx)``
returning the value, or None where the run has nothing for it to read.
``ctx`` is ``run.Context``. The end-to-end metrics and the per-layer ones
are read alike."""
