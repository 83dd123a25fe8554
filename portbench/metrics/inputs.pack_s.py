"""``inputs.pack_s``: host seconds of the program's packing in set-up
(``BAProblem`` construction and the traffic's ``pack`` entry), between
two synchronizations; moves ``setup_s``."""

from portbench.readers import pack_s as read  # noqa: F401
