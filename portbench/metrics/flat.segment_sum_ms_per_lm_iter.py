"""``flat.segment_sum_ms_per_lm_iter``: device ms of the segment-sum
kernels (``index_add_``'s ``indexFunc*``, scatters) per LM iteration."""

from portbench.readers import segment_sum_ms_per_lm_iter as read  # noqa: F401
