"""W8A8 dynamic-quantized matmuls for the decode loop
(port of ``icd_tpu/ops/qlinear.py:28-90``).

The LSTM gate weights and the vocab projection are stored as
per-output-channel int8; each step quantizes its (B, I) activations per
row (dynamic, symmetric), sums in int32 with ``torch._int_mm`` and
dequantizes with the outer product of the scales. No calibration is
needed: the activations are (B, I)-sized.

Weights are in the JAX package's (I, O) layout, ``wq`` (I, O) int8 and
``ws`` (O,) f32, with two differences that cuBLASLt's int8 product asks
for: ``wq``'s columns are padded with zeros to a multiple of 8 (a real
vocabulary such as 9,490 words is not one) and stored column-major
(``ops.quant.pad_columns``). ``qmatmul`` slices the padding off the
product, whose true width is ``ws``'s length. Rows of a small batch are
padded to 17 inside ``ops.quant.int_mm``.

The arithmetic follows the JAX package's order: ``quantize_rows`` and
``quantize_linear`` divide (``ops.quant.div`` for the 127: a true
division on the card too), rounding is half to even, and
the product is ``acc * (xs * ws)`` with the outer product formed first,
so ``qmatmul`` equals the JAX function bit for bit.
"""

import torch

from ..models.lstm import gates_to_state
from .quant import div, int_mm, pad_columns


def quantize_linear(w):
    """(I, O) float -> (wq int8 (I, O padded to 8) column-major,
    scale (O,) f32), per output channel (qlinear.py:28)."""
    w = w.detach().float()
    s = div(w.abs().amax(dim=0), 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return pad_columns(q), s


def quantize_rows(x):
    """(B, I) float -> (xq int8, scale (B, 1) f32), per row, symmetric."""
    x = x.float()
    s = div(x.abs().amax(dim=1, keepdim=True), 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def qmatmul(x, wq, ws):
    """Dynamic W8A8 x @ w: quantize x per row, int32 sums, dequantize
    with the outer product of the scales. Returns (B, O) f32."""
    xq, xs = quantize_rows(x)
    acc = int_mm(xq, wq, ws.shape[0])
    return acc.float() * (xs * ws)


def quantize_lstm(cell):
    """``nn.LSTMCell`` -> int8 gate weights, ``wiq`` (in, 4H) and ``whq``
    (H, 4H), and the two biases summed in f32 (qlinear.py:54)."""
    wiq, wis = quantize_linear(cell.weight_ih.t())
    whq, whs = quantize_linear(cell.weight_hh.t())
    bias = cell.bias_ih.detach().float() + cell.bias_hh.detach().float()
    return {"wiq": wiq, "wis": wis, "whq": whq, "whs": whs, "b": bias}


def qlstm_cell(qp, x, h, c):
    """``lstm_cell`` with W8A8 gate products; x, h, c f32, returns f32
    (qlinear.py:63).

    ``x`` may be a tuple of segments of the input row, each quantized
    with its own per-row scale (the attention decoder's embedding and
    gated context differ in range); the segments take consecutive rows
    of ``wiq`` and must cover all of them.
    """
    segs = x if isinstance(x, tuple) else (x,)
    off, acc = 0, None
    for seg in segs:
        w = qp["wiq"][off:off + seg.shape[-1]]
        t = qmatmul(seg, w, qp["wis"])
        acc = t if acc is None else acc + t
        off += seg.shape[-1]
    if off != qp["wiq"].shape[0]:
        raise ValueError(
            f"qlstm_cell input segments cover {off} rows of the "
            f"{qp['wiq'].shape[0]}-row input weight; a mis-split input "
            "would silently drop the remaining rows' gate contributions")
    gates = acc + qmatmul(h, qp["whq"], qp["whs"]) + qp["b"]
    return gates_to_state(gates, c)
