"""``device.idle_pct.wtt``: the traced window less the union of device
intervals, over the window, in percent (wtt cells)."""

from portbench.readers import idle_pct as read  # noqa: F401
