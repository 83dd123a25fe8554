"""``solver.launches_per_lm_iter``: ``cudaLaunchKernel`` calls in the
traced window over its LM iterations (flat cells)."""

from portbench.readers import launches_per_lm_iter as read  # noqa: F401
