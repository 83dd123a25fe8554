"""``solver.launches_per_lm_iter.wtt``: ``cudaLaunchKernel`` calls in the
traced window over its LM iterations (wtt cells)."""

from portbench.readers import launches_per_lm_iter as read  # noqa: F401
