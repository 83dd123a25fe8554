"""Tool helpers: timing (``timing``), solve checkpoints (``checkpoint``),
the host process pool (``multiprocess``), the disk cache of built
problems (``problem_cache``) and the scene exports (``visualization``)."""
