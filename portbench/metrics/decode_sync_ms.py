"""decode_sync_ms: total length of the program's ``beam_sync`` /
``greedy_sync`` spans over the number of decode steps, the host's ms a
step waiting for the card at the loop's checks."""

from ._spans import DECODE_STEPS, DECODE_SYNCS, ms_per


def read(reading):
    return ms_per(reading, DECODE_SYNCS, DECODE_STEPS)
