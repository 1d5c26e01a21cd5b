"""The reference's LSTM baseline (models/encoder.py:22-58,
models/baseline.py:19-57): ResNet-101 globally pooled, Linear(2048 ->
E), then one LSTM cell that takes the image feature as its first input
and each previous token's embedding after it, and Linear(H -> V).
float32, weights read from a dict (``embed.*``, ``decoder.embedding``,
``decoder.lstm.*``, ``decoder.linear.*``). ``products`` may replace
every product with a lower-precision one (the control)."""

import torch

from . import resnet


def _exact(x, w):
    return x @ w.t()


@torch.no_grad()
def teacher_forced_logits(w, imgs, served, depths, products=_exact,
                          conv=resnet._conv):
    """Logits (B, T, V) of each step of ``served`` (B, T) tokens: step 0
    from the image feature, step t from token t - 1."""
    feats = features(w, imgs, depths, products, conv)
    return _logits(w, feats, served, products)


def features(w, imgs, depths, products=_exact, conv=resnet._conv):
    pooled = resnet.pooled(w, imgs, depths, conv=conv)
    return products(pooled, w["embed.weight"]) + w["embed.bias"]


def _cell(w, x, h, c, products):
    gates = (products(x, w["decoder.lstm.weight_ih"])
             + w["decoder.lstm.bias_ih"]
             + products(h, w["decoder.lstm.weight_hh"])
             + w["decoder.lstm.bias_hh"])
    i, f, g, o = gates.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _logits(w, feats, served, products):
    emb = w["decoder.embedding.weight"]
    h = feats.new_zeros(feats.shape[0], w["decoder.lstm.weight_hh"].shape[1])
    c = torch.zeros_like(h)
    out = []
    for t in range(served.shape[1]):
        x = feats if t == 0 else emb[served[:, t - 1]]
        h, c = _cell(w, x, h, c, products)
        out.append(products(h, w["decoder.linear.weight"])
                   + w["decoder.linear.bias"])
    return torch.stack(out, dim=1)


@torch.no_grad()
def greedy(w, feats, steps, products=_exact):
    """Greedy tokens (B, steps) from image features, the first maximum
    at each step."""
    emb = w["decoder.embedding.weight"]
    h = feats.new_zeros(feats.shape[0], w["decoder.lstm.weight_hh"].shape[1])
    c = torch.zeros_like(h)
    x, toks = feats, []
    for _ in range(steps):
        h, c = _cell(w, x, h, c, products)
        logits = products(h, w["decoder.linear.weight"]) \
            + w["decoder.linear.bias"]
        tok = logits.argmax(dim=1)
        toks.append(tok)
        x = emb[tok]
    return torch.stack(toks, dim=1)
