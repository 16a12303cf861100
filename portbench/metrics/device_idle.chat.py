"""device_idle.chat: the share of a profiled stretch of the window in which
no kernel, copy or set ran on the card (device trace): 1 - the union of
their intervals over the stretch."""

from portbench.metrics._util import idle_percent


def read(record):
    return idle_percent(record)
