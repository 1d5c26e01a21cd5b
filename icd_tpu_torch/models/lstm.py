"""LSTM cell and sequence (port of ``icd_tpu/models/lstm.py:49-98``).

Weights live in an ``nn.LSTMCell`` (``weight_ih`` (4H, in), ``weight_hh``
(4H, H), ``bias_ih``, ``bias_hh``), which is the JAX tree's ``wi``/``wh``
transposed. The step itself is written out so that the gate order and
the order of the bias additions are the JAX package's, not cuDNN's
(``nn.LSTM`` and cuDNN's RNN fuse the gates in their own order).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def init_lstm(generator, input_size, hidden_size, dtype=torch.float32):
    """torch LSTMCell default init: U(-1/sqrt(H), 1/sqrt(H)) on all
    (lstm.py:19), drawn from ``generator`` on the CPU."""
    cell = nn.LSTMCell(input_size, hidden_size, device="meta")
    bound = 1.0 / math.sqrt(hidden_size)
    cell = cell.to_empty(device="cpu")
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)
    return cell.to(dtype)


def gates_to_state(gates, c):
    """(B, 4H) pre-activation gates -> (new_h, new_c).

    The (i, f, g, o) gate order is PyTorch's and the JAX package's
    (weight-convert parity).
    """
    i, f, g, o = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return new_h, new_c


def lstm_cell(cell, x, h, c):
    """One LSTM step. x: (B, in), h/c: (B, H) -> (new_h, new_c)."""
    gates = (F.linear(x, cell.weight_ih) + cell.bias_ih
             + F.linear(h, cell.weight_hh) + cell.bias_hh)
    return gates_to_state(gates, c)


def lstm_scan(cell, xs, h0=None, c0=None):
    """Run the cell over a batch-major sequence (lstm.py:73).

    xs: (B, T, in); h0/c0: (B, H), zeros in ``xs``'s dtype when None.
    Returns (outputs (B, T, H), (h_T, c_T)).
    """
    batch = xs.shape[0]
    shape = (batch, cell.hidden_size)
    h = xs.new_zeros(shape) if h0 is None else h0
    c = xs.new_zeros(shape) if c0 is None else c0
    outs = []
    for t in range(xs.shape[1]):
        h, c = lstm_cell(cell, xs[:, t], h, c)
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)
