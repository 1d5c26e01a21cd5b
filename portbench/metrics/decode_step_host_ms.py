"""decode_step_host_ms: mean length of the program's ``beam_step`` /
``greedy_step`` spans, the host's ms to dispatch one decode step, the
loop's sync left out."""

from ._spans import DECODE_STEPS, ms_per


def read(reading):
    return ms_per(reading, DECODE_STEPS, DECODE_STEPS)
