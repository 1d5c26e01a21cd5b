"""What several readers share."""


def mean_span_ms(reading, name):
    spans = reading.spans_named(name)
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)


def idle_pct(reading):
    """Share of the traced window with no device operation running."""
    if reading.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)


def peak_share_pct(reading):
    """Seconds the window's work takes at the card's peaks, over the
    window's seconds."""
    c = reading.counters
    if not c.get("window_s"):
        return None
    return 100.0 * c["work_at_peak_s"] / c["window_s"]


def elem_bytes(traffic):
    return {"bfloat16": 2, "float32": 4}[traffic["dtype"]]
