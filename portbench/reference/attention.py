"""The soft-attention captioner of "Show, Attend and Tell" (Xu et al.
2015, arXiv:1502.03044) as its reference implementation writes the
decoder (models/attention.py:18-284): additive attention over the grid's
pixels, a sigmoid gate f_beta(h) on the context, an LSTM cell over
[embedding | gated context], and fc over h (dropout before fc in
training). float32, step by step, weights read from a dict by the names
``decoder.attention.enc_att.weight`` ... ``decoder.embedding.weight``.
"""

import torch
import torch.nn.functional as F


def _lin(w, name, x):
    return x @ w[name + ".weight"].t() + w[name + ".bias"]


def lstm_cell(w, x, h, c):
    gates = (x @ w["decoder.lstm.weight_ih"].t() + w["decoder.lstm.bias_ih"]
             + h @ w["decoder.lstm.weight_hh"].t()
             + w["decoder.lstm.bias_hh"])
    i, f, g, o = gates.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class Decoder:
    """The decoder over a (B, P, D) grid: ``step(tokens, h, c)`` feeds
    the previous tokens and returns (h, c, logits, alpha)."""

    def __init__(self, w, grid):
        self.w, self.grid = w, grid
        self.att_enc = _lin(w, "decoder.attention.enc_att", grid)
        mean = grid.mean(dim=1)
        self.h0 = _lin(w, "decoder.h_lin", mean)
        self.c0 = _lin(w, "decoder.c_lin", mean)

    def step(self, emb, h, c):
        w = self.w
        att_dec = _lin(w, "decoder.attention.dec_att", h)
        scores = _lin(w, "decoder.attention.full_att",
                      F.relu(self.att_enc + att_dec[:, None, :]))[..., 0]
        alpha = torch.softmax(scores, dim=1)
        context = (alpha[:, :, None] * self.grid).sum(dim=1)
        gate = torch.sigmoid(_lin(w, "decoder.f_beta", h))
        h, c = lstm_cell(w, torch.cat([emb, gate * context], dim=1), h, c)
        return h, c, alpha

    def logits(self, h):
        return _lin(self.w, "decoder.fc", h)


@torch.no_grad()
def teacher_forced_logprobs(w, grid, inputs):
    """Log-probabilities (B, T, V) of the next token at each of T steps,
    fed ``inputs`` (B, T) (``<start>`` then the served tokens), and the
    attention maps (B, T, P) of those steps."""
    dec = Decoder(w, grid)
    emb = w["decoder.embedding.weight"][inputs]
    h, c = dec.h0, dec.c0
    out, alphas = [], []
    for t in range(inputs.shape[1]):
        h, c, alpha = dec.step(emb[:, t], h, c)
        out.append(torch.log_softmax(dec.logits(h), dim=1))
        alphas.append(alpha)
    return torch.stack(out, dim=1), torch.stack(alphas, dim=1)


def train_loss(w, grid, captions, keep, dropout, alpha_c):
    """The training loss on a batch whose captions (B, T) are padded to
    its longest: every row decodes T - 1 steps (lengths are measured
    after padding), fc reads h through dropout's ``keep`` mask (B, T - 1,
    H), and the loss is the cross-entropy over all B x (T - 1) positions
    plus alpha_c * mean((1 - sum over steps of alpha)^2)."""
    dec = Decoder(w, grid)
    emb = w["decoder.embedding.weight"][captions]
    h, c = dec.h0, dec.c0
    logits, alphas = [], []
    for t in range(captions.shape[1] - 1):
        h, c, alpha = dec.step(emb[:, t], h, c)
        dropped = torch.where(keep[:, t], h / (1.0 - dropout), 0.0)
        logits.append(dec.logits(dropped))
        alphas.append(alpha)
    logits = torch.stack(logits, dim=1)
    ce = F.cross_entropy(logits.flatten(0, 1), captions[:, 1:].flatten())
    reg = ((alpha_c - torch.stack(alphas, dim=1).sum(dim=1)) ** 2).mean()
    return ce + reg
