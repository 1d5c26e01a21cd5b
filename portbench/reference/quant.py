"""Symmetric integer fake quantization, for the controls: every product
of the reference taken on ``bits``-bit integers (weights per output
channel, activations per tensor, both rounded to nearest), the sums in
float32."""

import torch
import torch.nn.functional as F


def fake_quant(x, bits, dims=None):
    qmax = 2 ** (bits - 1) - 1
    top = x.abs().amax() if dims is None else x.abs().amax(dim=dims,
                                                            keepdim=True)
    scale = (top / qmax).clamp_min(1e-12)
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def products(bits):
    """``products(x, w)`` = x w^T on ``bits``-bit operands."""
    def product(x, w):
        return fake_quant(x, bits) @ fake_quant(w, bits, dims=1).t()
    return product


def convolution(bits):
    """``conv(x, w, stride, padding)`` on ``bits``-bit operands."""
    def conv(x, w, stride=1, padding=0):
        return F.conv2d(fake_quant(x, bits), fake_quant(w, bits, (1, 2, 3)),
                        stride=stride, padding=padding)
    return conv
