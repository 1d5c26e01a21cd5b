"""Batched greedy decoding for the baseline decoder
(port of ``icd_tpu/decoding/greedy.py``).

There is no ``<start>`` token: step 0 feeds the image feature to the
LSTM and its argmax is the first token (greedy.py:35-40); each later
step feeds the previous token's embedding. The JAX package runs the
later steps in a ``lax.while_loop`` with an all-finished exit; here
they are a host loop that stops when every caption has emitted
``<end>`` (one host sync a step). Tokens after a caption's ``<end>``
are ``end_id``.

The float decoder carries h and c in the features' dtype; the W8A8 one
(``ops/qlinear.py``) carries them in f32 and reads each embedding row
from a table kept in the compute dtype, then widened to f32
(greedy.py:107-122).
"""

import torch
import torch.nn.functional as F

from ..models.lstm import lstm_cell
from ..ops.qlinear import qlstm_cell, qmatmul, quantize_linear, quantize_lstm
from ..utils.profiling import annotate

MAX_STEPS = 50  # reference caps generation at 50 steps (gen_captions.py:119)


def _greedy_tokens(step, h, c, logits, end_id, max_len):
    """The loop of both baseline decoders: ``logits`` are step 0's;
    ``step(tok, h, c) -> (h, c, logits)`` runs the next steps.

    It stays apart from ``greedy_attention._greedy_loop``: that loop
    starts from ``<start>`` rather than from a step already run, freezes
    h and c once a caption has ended and records each step's alphas.
    Both keep the JAX exit policy (first-maximum argmax, ``end_id``
    after ``<end>``, stop when every caption has ended). Under a
    profiler each later step's host check is a span ``greedy_sync`` and
    the rest of the step a ``greedy_step``."""
    first = logits.argmax(dim=-1)  # the first maximum, as jnp.argmax
    toks = torch.full((first.shape[0], max_len), end_id, dtype=torch.long,
                      device=first.device)
    toks[:, 0] = first
    finished = first == end_id
    tok = first
    for i in range(1, max_len):
        with annotate("greedy_sync"):
            done = bool(finished.all())
        if done:
            break
        with annotate("greedy_step"):
            h, c, logits = step(tok, h, c)
            tok = torch.where(finished, end_id, logits.argmax(dim=-1))
            toks[:, i] = tok
            finished = finished | (tok == end_id)
    return toks


@torch.no_grad()
def greedy_decode_baseline(decoder, img_features, start_id, end_id,
                           max_len=MAX_STEPS):
    """Greedy decode from (B, embed_size) features (greedy.py:18), at the
    decoder's dtype and device. ``start_id`` is not read, as there.

    Returns (B, max_len) long tokens.
    """
    lin = decoder.linear

    def logits_of(h):
        return F.linear(h, lin.weight) + lin.bias

    def step(tok, h, c):
        h, c = lstm_cell(decoder.lstm, decoder.embedding(tok), h, c)
        return h, c, logits_of(h)

    h = img_features.new_zeros((img_features.shape[0],
                                decoder.lstm.hidden_size))
    h, c = lstm_cell(decoder.lstm, img_features, h, torch.zeros_like(h))
    return _greedy_tokens(step, h, c, logits_of(h), end_id, max_len)


@torch.no_grad()
def quantize_baseline_decoder(decoder):
    """W8 int8 serving weights of the LSTM gates and the vocab projection
    (greedy.py:69), from the decoder's own weights. The embedding table
    stays float: a step gathers only B rows of it."""
    wq, ws = quantize_linear(decoder.linear.weight.t())
    return {"embedding": decoder.embedding.weight.detach(),
            "lstm": quantize_lstm(decoder.lstm),
            "linear": {"wq": wq, "ws": ws,
                       "b": decoder.linear.bias.detach().float()}}


@torch.no_grad()
def greedy_decode_baseline_int8(qdec, img_features, start_id, end_id,
                                max_len=MAX_STEPS):
    """``greedy_decode_baseline`` over ``quantize_baseline_decoder``
    weights (greedy.py:88): W8A8 gate and vocab products, h and c f32.
    Near-tie argmax tokens can differ from the float path."""
    lin, emb = qdec["linear"], qdec["embedding"]

    def logits_of(h):
        return qmatmul(h, lin["wq"], lin["ws"]) + lin["b"]

    def step(tok, h, c):
        h, c = qlstm_cell(qdec["lstm"], emb[tok].float(), h, c)
        return h, c, logits_of(h)

    h = torch.zeros((img_features.shape[0], qdec["lstm"]["whq"].shape[0]),
                    dtype=torch.float32, device=img_features.device)
    h, c = qlstm_cell(qdec["lstm"], img_features.float(), h,
                      torch.zeros_like(h))
    return _greedy_tokens(step, h, c, logits_of(h), end_id, max_len)
