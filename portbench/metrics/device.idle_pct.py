"""``device.idle_pct``: the traced window less the union of device
intervals, over the window, in percent (flat cells)."""

from portbench.readers import idle_pct as read  # noqa: F401
