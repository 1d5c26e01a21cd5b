"""serve_mfu: the window's served batches' model operations
(``portbench/counts``: the encoder, the decoder at the steps each
request's loop ran), each part at the card's peak for the type it runs
in, as seconds, over the window's seconds."""

from ._common import peak_share_pct


def read(reading):
    return peak_share_pct(reading)
