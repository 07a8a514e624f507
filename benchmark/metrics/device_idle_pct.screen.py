"""The share of the traced window in which no operation ran on the card
(busy time: the union of the device operations' intervals)."""

from harness.readers import idle_pct


def read(run):
    return idle_pct(run)
