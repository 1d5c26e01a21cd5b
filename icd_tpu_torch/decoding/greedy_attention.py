"""Batched greedy decoding for the attention decoder
(port of ``icd_tpu/decoding/greedy_attention.py``).

The JAX package runs a ``lax.while_loop`` with an all-finished exit;
here it is a host loop over the batch, one step per iteration, that
stops when every caption has emitted ``<end>`` (one host sync a step).
Each step takes its attention and gate from K1
(``ops/fused_attention.py``) with one row per image.

Contract (greedy_attention.py:38-45): tokens after a caption's ``<end>``
are ``end_id``; alpha rows after it are zero f32, and in-caption rows
are softmax rows over the P pixels.
"""

import torch

from ..models.attention import decode_step, init_hidden_state
from ..ops.fused_attention import fused_attention
from ..ops.qlinear import qlstm_cell, qmatmul, quantize_linear, quantize_lstm
from .greedy import MAX_STEPS


def _flat(encoder_grid):
    b = encoder_grid.shape[0]
    return encoder_grid.reshape(b, -1, encoder_grid.shape[-1]).contiguous()


def _greedy_loop(step, h, c, batch, p, start_id, end_id, max_len, device):
    """The shared loop: ``step(tok, h, c) -> (h2, c2, logits, alpha)``."""
    tok = torch.full((batch,), start_id, dtype=torch.long, device=device)
    finished = torch.zeros((batch,), dtype=torch.bool, device=device)
    toks = torch.full((batch, max_len), end_id, dtype=torch.long,
                      device=device)
    alphas = torch.zeros((batch, max_len, p), dtype=torch.float32,
                         device=device)
    for i in range(max_len):
        h2, c2, logits, alpha = step(tok, h, c)
        nxt = logits.argmax(dim=-1)  # the first maximum, as jnp.argmax
        nxt = torch.where(finished, end_id, nxt)
        keep = finished[:, None]
        h = torch.where(keep, h, h2)
        c = torch.where(keep, c, c2)
        alphas[:, i] = torch.where(keep, 0.0, alpha.float())
        toks[:, i] = nxt
        finished = finished | (nxt == end_id)
        tok = nxt
        if bool(finished.all()):
            break
    return toks, alphas


@torch.no_grad()
def greedy_decode_attention(decoder, encoder_grid, start_id, end_id,
                            max_len=MAX_STEPS):
    """Greedy decode from (B, gh, gw, D) or (B, P, D) encoder grids
    (greedy_attention.py:17), at the decoder's dtype and device.

    Returns (tokens (B, max_len) long, alphas (B, max_len, P) f32).
    """
    enc = _flat(encoder_grid)
    att_enc = decoder.attention.enc_att(enc)
    h, c = init_hidden_state(decoder, enc)

    def step(tok, h, c):
        return decode_step(decoder, enc, att_enc, decoder.embedding(tok),
                           h, c)

    return _greedy_loop(step, h, c, enc.shape[0], enc.shape[1], start_id,
                        end_id, max_len, enc.device)


@torch.no_grad()
def quantize_attention_decoder(decoder):
    """int8 weights for the decode loop's largest products, the LSTM gates
    and the vocab projection (greedy_attention.py:72), from the
    decoder's own (full-precision) weights; the attention and gate
    projections stay float."""
    wq, ws = quantize_linear(decoder.fc.weight.t())
    return {"lstm": quantize_lstm(decoder.lstm),
            "fc": {"wq": wq, "ws": ws,
                   "b": decoder.fc.bias.detach().float()}}


@torch.no_grad()
def greedy_decode_attention_int8(decoder, qdec, encoder_grid, start_id,
                                 end_id, max_len=MAX_STEPS):
    """``greedy_decode_attention`` with W8A8 LSTM and fc products
    (greedy_attention.py:88; ``qdec`` from ``quantize_attention_decoder``).

    ``decoder`` supplies the attention, the gate, h_lin/c_lin and the
    embedding (its lstm and fc are not read). The attention and gate of
    :118-120, ``soft_attention`` then ``sigmoid(f_beta(h))``, are K1's
    function, so they come from K1 with h cast to the grid's dtype; h and
    c stay f32. Near-tie argmax tokens can differ from the float path.
    """
    enc = _flat(encoder_grid)
    att = decoder.attention
    att_enc = att.enc_att(enc)
    h, c = init_hidden_state(decoder, enc)
    fb = decoder.f_beta

    def step(tok, h, c):
        emb = decoder.embedding(tok)
        gated, alpha = fused_attention(
            enc, att_enc, h.to(enc.dtype), att.dec_att.weight,
            att.dec_att.bias, att.full_att.weight[0], att.full_att.bias,
            fb.weight, fb.bias)
        # Segments quantize separately (per-segment row scales).
        x = (emb.float(), gated.float())
        h2, c2 = qlstm_cell(qdec["lstm"], x, h, c)
        logits = qmatmul(h2, qdec["fc"]["wq"], qdec["fc"]["ws"]) \
            + qdec["fc"]["b"]
        return h2, c2, logits, alpha

    return _greedy_loop(step, h.float(), c.float(), enc.shape[0],
                        enc.shape[1], start_id, end_id, max_len, enc.device)
