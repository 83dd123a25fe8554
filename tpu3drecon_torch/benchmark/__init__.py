"""Benchmark configurations, the BASELINE.md suite (``suite``), and the
cross-framework harness (``harness``, ``drivers``, ``datasets``,
``reporting`` and ``adapters``)."""
