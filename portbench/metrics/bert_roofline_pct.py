"""bert_roofline_pct: the least time of the traced steps' BERT forwards
(``portbench/counts/bert.py`` at each caption's own piece count: its
operations at the float32 peak or its bytes at the HBM rate, the
larger) over their device time (``bert_device_s``)."""


def read(reading):
    c = reading.counters
    if not c.get("bert_device_s") or "bert_bound_s" not in c:
        return None
    return 100.0 * c["bert_bound_s"] / c["bert_device_s"]
