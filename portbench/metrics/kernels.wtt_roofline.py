"""``kernels.wtt_roofline``: B1-B4's least time (bytes or operations,
``roofline.py``) over their device time in the traced window, in
percent."""

from portbench.readers import wtt_roofline as read  # noqa: F401
