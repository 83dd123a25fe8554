"""``solver.syncs_per_lm_iter.wtt``: ``cudaStreamSynchronize`` calls in the
traced window over its LM iterations (wtt cells)."""

from portbench.readers import syncs_per_lm_iter as read  # noqa: F401
