"""device.idle_pct.asmc: the share of the traced window of ASMC's jobs in
which no kernel, copy or memset ran on the card, in percent."""

from gpubench.readings import idle_pct as read  # noqa: F401
