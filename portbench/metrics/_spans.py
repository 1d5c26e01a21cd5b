"""What the readers of the program's own spans share (the spans
``icd_tpu_torch/utils/profiling.annotate`` records whenever a profiler
records: ``beam_step``, ``serve_upload``, ``train_wait``, ...). A
program without them gives None."""

DECODE_STEPS = ("beam_step", "greedy_step")
DECODE_SYNCS = ("beam_sync", "greedy_sync")


def span_ms(reading, names):
    """(total ms, count) of the spans named in ``names``."""
    lengths = [b - a for n, a, b in reading.spans if n in names]
    return 1e3 * sum(lengths), len(lengths)


def ms_per(reading, names, per):
    """Total ms of the spans ``names`` over the count of the spans
    ``per``; None when either is missing."""
    total, n = span_ms(reading, names)
    _, count = span_ms(reading, per)
    if n == 0 or count == 0:
        return None
    return total / count
