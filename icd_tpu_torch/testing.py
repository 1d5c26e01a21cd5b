"""Helpers of the card tests and ``chip_smoke.py``: random decoders that
finish their captions, seeded captions, and one train step recorded for
comparison across devices.

A random decoder never emits ``<end>`` among thousands of near-equal
logits, so every beam search would run to its step limit. ``steer_end``
gives one LSTM unit the job of counting steps and makes it the only
input of the ``<end>`` logit, so captions end after a number of steps
that depends on the image.
"""

import copy
import math

import torch

from .models.attention import AttentionDecoderParams, init_attention_decoder


def steer_end(decoder, end_id, rate=0.05, spread=0.1, threshold=20.0,
              unit=0):
    """Steer ``decoder`` in place: LSTM unit ``unit`` counts steps (i, f, o
    gates open, c from 0, g = tanh(atanh(rate) + spread * ctx . w) with w a
    zero-mean unit vector) and is the only input of the <end> logit,
    40 * h_unit - threshold."""
    hd = decoder.lstm.hidden_size
    emb = decoder.embedding.embedding_dim
    i, f, g, o = (gate * hd + unit for gate in range(4))
    lstm = decoder.lstm
    with torch.no_grad():
        lstm.weight_ih[[i, f, o]] = 0.0
        lstm.weight_hh[[i, f, g, o]] = 0.0
        lstm.bias_ih[[i, f, o]] = 10.0
        lstm.bias_hh[[i, f, g, o]] = 0.0
        w = lstm.weight_ih[g, emb:]
        w = w - w.mean()  # blind to the grid's common offset
        lstm.weight_ih[g, emb:] = spread * w / w.norm()
        lstm.weight_ih[g, :emb] = 0.0
        lstm.bias_ih[g] = math.atanh(rate)
        decoder.c_lin.weight[unit] = 0.0
        decoder.c_lin.bias[unit] = 0.0
        decoder.fc.weight[end_id] = 0.0
        decoder.fc.weight[end_id, unit] = 40.0
        decoder.fc.bias[end_id] = -threshold


def steered_decoder(vocab, att, dec, emb, enc, seed, device=None):
    """A small random decoder from ``seed``, steered to finish captions
    (<end> is vocab - 2)."""
    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim = att, dec
    params.embed_size, params.vocab = emb, range(vocab)
    decoder = init_attention_decoder(torch.Generator().manual_seed(seed),
                                     params, encoder_dim=enc, device=device)
    steer_end(decoder, vocab - 2, rate=0.1, spread=1.0)
    return decoder


def seeded_captions(generator, n, length, vocab, start_id, end_id,
                    min_words=8):
    """(n, length) int32 captions: ``<start>``, between ``min_words`` and
    ``length - 2`` words, ``<end>``, then ``<pad>`` (0). Words are ids 1 to
    vocab - 4 drawn from a Zipf law over their rank (p ~ 1 / rank^1.1),
    as word counts in captions fall off."""
    ranks = torch.arange(1, vocab - 3, dtype=torch.float64)
    probs = ranks ** -1.1
    out = torch.zeros(n, length, dtype=torch.int32)
    words = torch.multinomial(probs, n * (length - 2), replacement=True,
                              generator=generator).view(n, length - 2) + 1
    counts = torch.randint(min_words, length - 1, (n,), generator=generator)
    for row, count in enumerate(counts.tolist()):
        out[row, 0] = start_id
        out[row, 1:1 + count] = words[row, :count]
        out[row, 1 + count] = end_id
    return out


def f32_products(tf32=False):
    """TF32 off for f32 convolutions and matmuls (``use_exact_f32``), or
    on with ``tf32``: a fault the comparisons across devices must catch."""
    from .device import use_exact_f32

    use_exact_f32()
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def train_step_record(encoder, decoder, imgs, captions, decode_lengths,
                      device, lr=1e-4, grad_clip=5.0, alpha_c=1.0,
                      tf32=False):
    """One train step (dropout 0, f32 with TF32 off unless ``tf32``) of
    copies of ``encoder`` and ``decoder`` on ``device``. Returns the loss
    and, as CPU tensors keyed by name, the decoder's gradients before
    clipping (``grads``), its updated parameters (``params``), Adam's
    moments (``exp_avg``, ``exp_avg_sq``) and the encoder's new BN
    statistics (``bn``)."""
    from .training.attention import make_train_step, trainable_parameters
    from .training.common import make_optimizer

    f32_products(tf32)
    encoder = copy.deepcopy(encoder).to(device)
    decoder = copy.deepcopy(decoder).to(device)
    enc_params, dec_params = trainable_parameters(encoder, decoder)
    optimizer = make_optimizer(enc_params, dec_params, lr, lr)
    def host(t):  # a copy: on the CPU, .cpu() would alias what clipping
        return t.detach().to("cpu", copy=True)  # and Adam change in place

    grads, names = {}, {p: n for n, p in decoder.named_parameters()}
    for p in dec_params:
        p.register_hook(lambda g, n=names[p]: grads.__setitem__(n, host(g)))
    step = make_train_step(encoder, decoder, optimizer, alpha_c, 0.0,
                           grad_clip)
    loss = step(imgs.to(device), captions.to(device),
                decode_lengths.to(device)).item()
    state = {names[p]: s for p, s in optimizer.state.items()}
    return {
        "loss": loss,
        "grads": grads,
        "params": {names[p]: host(p) for p in dec_params},
        "exp_avg": {n: host(s["exp_avg"]) for n, s in state.items()},
        "exp_avg_sq": {n: host(s["exp_avg_sq"]) for n, s in state.items()},
        "bn": {n: host(b) for n, b in encoder.named_buffers()},
    }


def decoder_grads(decoder, grid, captions, decode_lengths, device,
                  alpha_c=1.0, tf32=False):
    """The gradients of the train loss (dropout 0, f32 with TF32 off
    unless ``tf32``) of a copy of ``decoder`` on ``device`` at ``grid``,
    as CPU tensors keyed by name: the decoder's half of a train step,
    from a grid given to both devices alike."""
    from .training.attention import decoder_loss

    f32_products(tf32)
    decoder = copy.deepcopy(decoder).to(device)
    decoder.embedding.weight.requires_grad_(False)
    loss = decoder_loss(decoder, grid.to(device), captions.to(device),
                        decode_lengths.to(device), alpha_c)
    loss.backward()
    return {n: p.grad.detach().to("cpu", copy=True)
            for n, p in decoder.named_parameters() if p.grad is not None}


def relative_errors(got, want):
    """{name: max |got - want| / max |want|} over two dicts of tensors
    (every name of ``want``)."""
    return {name: ((got[name] - w).abs().max()
                   / w.abs().max().clamp(min=1e-30)).item()
            for name, w in want.items()}


SCORE_BIAS = "attention.full_att.bias"


def train_step_errors(got, want, lr):
    """How far one ``train_step_record`` is from another: the loss's
    relative error; per tensor, max |d| / max |want| of the gradients,
    Adam's moments and the BN statistics (``relative_errors``); the
    share of the updated parameters' elements that differ by more than
    lr / 100 (a first Adam step moves each element by less than lr on
    either side, so their largest difference is below 2 lr whatever the
    gradients). The score
    bias's gradient is zero in exact arithmetic (the softmax ignores a
    shift of every score), so its gradient and moments are left out of
    the relative errors and its largest gradient on each side is
    returned as ``score_bias_grad``."""
    out = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "score_bias_grad": [r["grads"][SCORE_BIAS].abs().max().item()
                               for r in (got, want)]}
    for key in ("grads", "exp_avg", "exp_avg_sq", "bn"):
        out[key] = relative_errors(
            {n: t for n, t in got[key].items() if n != SCORE_BIAS},
            {n: t for n, t in want[key].items() if n != SCORE_BIAS})
    steps = [(got["params"][n] - p).abs() / lr
             for n, p in want["params"].items()]
    out["step_share_beyond"] = (sum(int((d > 1e-2).sum()) for d in steps)
                                / sum(d.numel() for d in steps))
    return out
