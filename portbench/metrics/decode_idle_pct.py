"""decode_idle_pct: share of the ``decode`` spans' time in which no
device operation ran (the device waiting for the decode loop's host
work)."""


def read(reading):
    spans = reading.spans_named("decode")
    total = sum(b - a for a, b in spans)
    if not spans or reading.busy_s <= 0.0 or total <= 0.0:
        return None
    busy = sum(reading.busy_within(a, b) for a, b in spans)
    return 100.0 * (1.0 - busy / total)
