"""train_idle_pct: share of the traced training window with no device
operation running."""

from ._common import idle_pct


def read(reading):
    return idle_pct(reading)
