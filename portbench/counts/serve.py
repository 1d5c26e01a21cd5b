"""Model operations of a served batch, counted from shapes.

The encoder is ResNet-101's convolutions (2 operations a multiply-add;
BN, ReLU and pooling left out), 15.6 GFLOP an image at 224x224 as
``icd_tpu_torch/bench.py`` counts it. The decoders' products are counted
a step, for the rows a step computes, whatever their beams hold.
"""


def _out(size, stride):
    return (size - 1) // stride + 1


def resnet_gflop(depths, widths, image_size, expansion=4):
    """GFLOP of one image through the backbone's convolutions."""
    size = _out(image_size, 2)  # 7x7 stem, stride 2
    macs = size * size * widths[0] * 3 * 49
    size = _out(size, 2)  # 3x3 max pool, stride 2
    cin = widths[0]
    for stage, (depth, width) in enumerate(zip(depths, widths)):
        for block in range(depth):
            stride = 2 if stage > 0 and block == 0 else 1
            cout = width * expansion
            macs += size * size * cin * width  # conv1, 1x1
            out = _out(size, stride)
            macs += out * out * width * width * 9  # conv2, 3x3
            macs += out * out * width * cout  # conv3, 1x1
            if stride != 1 or cin != cout:
                macs += out * out * cin * cout  # downsample, 1x1
            size, cin = out, cout
    return 2.0 * macs / 1e9


def attention_request_gflop(b, p, d, a):
    """Once a batch: the grid's attention projection (B, P, D) -> A and
    h0, c0 from the mean pixel."""
    return (2 * b * p * d * a + 2 * 2 * b * d * a) / 1e9


def attention_step_gflop(rows, p, d, a, h, e, v):
    """One decode step of ``rows`` beams: dec_att and the f_beta gate
    (products of h), scores (add, relu, multiply-add per term), the
    context sum, the LSTM gates over [emb | context | h] and fc."""
    return (2 * rows * h * (a + d) + 4 * rows * p * a + 2 * rows * p * d
            + 2 * rows * (e + d + h) * 4 * h + 2 * rows * h * v) / 1e9


def baseline_head_gflop(b, d, e):
    """The pooled feature's ``embed`` product."""
    return 2 * b * d * e / 1e9


def baseline_step_gflop(b, e, h, v):
    """One greedy step of the baseline: the LSTM gates over [x | h] and
    the vocabulary projection."""
    return (2 * b * (e + h) * 4 * h + 2 * b * h * v) / 1e9
