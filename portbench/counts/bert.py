"""BERT's forward over a batch of captions, counted from each row's own
piece count n (frozen; ``chip_smoke.bert_forward_gflop`` counts the
operations the same way): per layer the q, k, v, o and feed-forward
products, 2 n (4 H^2 + 2 H F), and the attention's two (n, n) products,
4 H n^2. Padding the rows to the longest adds no work here. Bytes: the
layers' weights and the embedding LayerNorm read once, and each piece's
word and position rows, in float32. The bound is the larger of the
operations at the float32 peak and the bytes at the HBM rate."""

from . import peaks


def forward_flops(lengths, bert):
    h, f = bert["hidden_size"], bert["intermediate_size"]
    per_piece = 2 * (4 * h * h + 2 * h * f)
    return bert["num_hidden_layers"] * sum(
        n * per_piece + 4 * h * n * n for n in lengths)


def forward_bytes(lengths, bert):
    h, f = bert["hidden_size"], bert["intermediate_size"]
    layer = 4 * h * h + 4 * h + 2 * h * f + f + h + 4 * h
    weights = bert["num_hidden_layers"] * layer + 2 * h + h  # + token type
    return 4 * (weights + 2 * h * sum(lengths))


def bound_s(lengths, bert):
    """Least seconds of one forward over rows of ``lengths`` pieces."""
    return max(forward_flops(lengths, bert) / peaks.F32_FLOP_PER_S,
               forward_bytes(lengths, bert) / peaks.HBM_BYTES_PER_S)
