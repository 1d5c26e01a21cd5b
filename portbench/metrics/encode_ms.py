"""encode_ms: mean time of the traced requests' ``encode`` span, the
program's ``Captioner.encode`` closed by a synchronisation."""

from ._common import mean_span_ms


def read(reading):
    return mean_span_ms(reading, "encode")
