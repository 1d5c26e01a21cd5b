"""Model operations of one training step, as
``icd_tpu_torch/bench_train.py`` counts them (a frozen copy of
``decoder_train_gflops``, the attention model; the frozen trunk's
forward is ``serve.resnet_gflop``)."""


def attention_decoder_train_gflop(b, t, p, d, a, h, e, v):
    """One decoder forward + backward at 3x the forward's products, for
    captions of padded length ``t`` (``t - 1`` decode steps): the
    hoisted encoder projection, h0 and c0, each step's dec_att, score,
    context, f_beta gate and LSTM gates, then the batched fc
    (elementwise work, the softmax and the embedding gather left
    out)."""
    td = t - 1
    fwd = (2 * b * p * d * a
           + 2 * 2 * b * d * h
           + td * (2 * b * h * a
                   + 2 * b * p * a
                   + 2 * b * p * d
                   + 2 * b * h * d
                   + 2 * b * (e + d + h) * 4 * h)
           + 2 * b * td * h * v)
    return 3.0 * fwd / 1e9
