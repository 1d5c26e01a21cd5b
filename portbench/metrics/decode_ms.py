"""decode_ms: mean time of the traced requests' ``decode`` span, the
program's ``Captioner.decode`` (the beam or greedy loop) closed by a
synchronisation."""

from ._common import mean_span_ms


def read(reading):
    return mean_span_ms(reading, "decode")
