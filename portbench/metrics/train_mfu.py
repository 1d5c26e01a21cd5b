"""train_mfu: the window's training steps' model operations
(``portbench/counts``: the frozen trunk's forward and the decoder's
forward and backward at each batch's decode length) at the card's
float32 peak, as seconds, over the window's seconds."""

from ._common import peak_share_pct


def read(reading):
    return peak_share_pct(reading)
