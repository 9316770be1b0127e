"""device.idle_pct.fastsmc: the share of the traced window in which no
kernel, copy or memset ran on the card, in percent."""

from gpubench.readings import idle_pct as read  # noqa: F401
