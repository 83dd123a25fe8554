"""``solver.sync_wait_ms_per_lm_iter.wtt``: host ms inside the program's ``sync.*``
spans, where its host waits on the card, per LM iteration of the traced
window, from the program's tally (wtt cells)."""

from portbench.spans import sync_wait_ms_per_lm_iter as read  # noqa: F401
