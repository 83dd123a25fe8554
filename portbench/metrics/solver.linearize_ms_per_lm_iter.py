"""``solver.linearize_ms_per_lm_iter``: host ms inside the program's span
``lm.linearize`` (the linearization and its normal blocks) per LM
iteration of the traced window, from the program's tally (flat cells)."""

from portbench.spans import linearize_ms_per_lm_iter as read  # noqa: F401
