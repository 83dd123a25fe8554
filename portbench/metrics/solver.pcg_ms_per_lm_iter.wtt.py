"""``solver.pcg_ms_per_lm_iter.wtt``: host ms inside the program's span ``pcg`` (the
whole CG solve) per LM iteration of the traced window, from the
program's tally (wtt cells)."""

from portbench.spans import pcg_ms_per_lm_iter as read  # noqa: F401
