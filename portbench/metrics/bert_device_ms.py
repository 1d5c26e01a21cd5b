"""bert_device_ms: the device time of the operations launched inside the
program's ``bert_forward`` spans (the entry's ``bert_device_s``, joined
on the profiler's launch correlation), ms a traced step; None without
such spans or device operations."""


def read(reading):
    c = reading.counters
    if not c.get("bert_device_s") or not c.get("traced_steps"):
        return None
    return 1e3 * c["bert_device_s"] / c["traced_steps"]
