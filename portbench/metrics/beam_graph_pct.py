"""beam_graph_pct: the share of the per-step beam loop's steps that the
program issued as one replay of a CUDA graph, 100 x its ``beam_replay``
spans over its ``beam_step`` spans in the traced block; None without
them (a program that replays no graph)."""

from ._spans import span_ms


def read(reading):
    _, replays = span_ms(reading, ("beam_replay",))
    _, steps = span_ms(reading, ("beam_step",))
    if replays == 0 or steps == 0:
        return None
    return 100.0 * replays / steps
