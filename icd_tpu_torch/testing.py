"""Helpers of the card tests and ``chip_smoke.py``: random decoders that
finish their captions, seeded captions, one train step of either model
family recorded for comparison across devices, and two ways to make a
second device take the first one's discrete choices (the attention's
relu branches, the W8A8 BERT's int8 roundings) so that the comparison
sees only their float work.

A random decoder never emits ``<end>`` among thousands of near-equal
logits, so every beam search would run to its step limit. ``steer_end``
gives one LSTM unit the job of counting steps and makes it the only
input of the ``<end>`` logit, so captions end after a number of steps
that depends on the image.
"""

import contextlib
import copy
import math
from unittest import mock

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
                      tf32=False, compute_dtype=None, qresnet=None,
                      embeddings=None):
    """One train step (dropout 0, f32 with TF32 off unless ``tf32``) of
    copies of ``encoder`` and ``decoder`` on ``device``, at
    ``compute_dtype`` (bf16: --amp), over the int8 trunk ``qresnet``
    (--int8_encoder) and on BERT's caption ``embeddings`` (--use_bert)
    when given. A baseline decoder (``decode_lengths`` None) trains with
    its encoder's head (--fine_tune_encoder) and <pad> 0. Returns the
    loss and, as CPU tensors keyed by name, the gradients before clipping
    (``grads``), the updated parameters (``params``),
    Adam's moments (``exp_avg``, ``exp_avg_sq``) and the encoder's BN
    statistics after the step (``bn``), and the frozen parameters
    (``frozen``)."""
    from .models.resnet_int8 import tree_to
    from .training import attention, baseline
    from .training.common import make_optimizer, trainable_parameters

    f32_products(tf32)
    encoder = copy.deepcopy(encoder).to(device)
    decoder = copy.deepcopy(decoder).to(device)
    if qresnet is not None:
        qresnet = tree_to(qresnet, device)
    head = decode_lengths is None
    enc_params, dec_params = trainable_parameters(encoder, decoder,
                                                  head=head)
    optimizer = make_optimizer(enc_params, dec_params, lr, lr)

    def host(t):  # a copy: on the CPU, .cpu() would alias what clipping
        return t.detach().to("cpu", copy=True)  # and Adam change in place

    names = {p: n for n, p in list(decoder.named_parameters())
             + list(encoder.named_parameters())}
    grads, trained = {}, enc_params + dec_params
    for p in trained:
        p.register_hook(lambda g, n=names[p]: grads.__setitem__(n, host(g)))
    if head:
        step = baseline.make_train_step(encoder, decoder, optimizer, 0,
                                        grad_clip, compute_dtype, qresnet)
        loss = step(imgs.to(device), captions.to(device))
    else:
        step = attention.make_train_step(encoder, decoder, optimizer,
                                         alpha_c, 0.0, grad_clip,
                                         compute_dtype, qresnet)
        loss = step(imgs.to(device), captions.to(device),
                    decode_lengths.to(device), None,
                    None if embeddings is None else embeddings.to(device))
    state = {names[p]: s for p, s in optimizer.state.items()}
    return {
        "loss": loss.item(),
        "grads": grads,
        "params": {names[p]: host(p) for p in trained},
        "exp_avg": {n: host(s["exp_avg"]) for n, s in state.items()},
        "exp_avg_sq": {n: host(s["exp_avg_sq"]) for n, s in state.items()},
        "bn": {n: host(b) for n, b in encoder.named_buffers()},
        "frozen": {n: host(p) for p, n in names.items()
                   if not p.requires_grad},
    }


class ReluBranches:
    """The branches the attention's relu takes over one forward, shared
    with the forwards after it.

    Within ``applied()``, ``torch.relu`` (which the decoder calls once a
    step, on att_enc + att_dec) records each call's mask x > 0 while
    ``masks`` is empty, and else returns x * mask with the recorded masks
    in turn, whatever the sign of x; ``flipped`` counts the elements of
    that forward whose own sign disagreed. Two devices' att_enc and
    att_dec round differently by ~1e-7 of their scale, so an element that
    close to zero takes the other branch on one of them and its whole
    term moves a row of enc_att's and dec_att's gradients; with the
    branches shared, the gradients differ by the float work only."""

    def __init__(self):
        self.masks, self.flipped = [], 0

    @contextlib.contextmanager
    def applied(self):
        record, replay, relu = not self.masks, iter(self.masks), torch.relu
        self.flipped = 0

        def branch(x):
            if record:
                self.masks.append((x > 0).cpu())
                return relu(x)
            mask = next(replay).to(x.device)
            self.flipped += int(((x > 0) != mask).sum())
            return x * mask

        with mock.patch.object(torch, "relu", branch):
            yield self


def decoder_grads(decoder, grid, captions, decode_lengths, device,
                  alpha_c=1.0, tf32=False, embeddings=None, branches=None):
    """The gradients of the train loss (dropout 0, f32 with TF32 off
    unless ``tf32``) of a copy of ``decoder`` on ``device`` at ``grid``
    (and on BERT's ``embeddings`` when given), as CPU tensors keyed by
    name: the decoder's half of a train step, from a grid given to both
    devices alike; with the relu ``branches`` (``ReluBranches``) when
    given."""
    from .training.attention import decoder_loss

    f32_products(tf32)
    decoder = copy.deepcopy(decoder).to(device)
    decoder.embedding.weight.requires_grad_(False)
    with (branches.applied() if branches is not None
          else contextlib.nullcontext()):
        loss = decoder_loss(decoder, grid.to(device), captions.to(device),
                            decode_lengths.to(device), alpha_c,
                            embeddings=None if embeddings is None
                            else embeddings.to(device))
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


def to_tf32(x):
    """An f32 tensor rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), as TF32 tensor cores read their operands; other
    dtypes unchanged."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def tf32_operands():
    """Within: ``torch.matmul`` rounds both operands to TF32 first. TF32
    mode changes a product only where cuBLAS picks a tensor-core kernel,
    and for BERT's attention products ((B·heads, L, 64) by (64, L)) it
    may not; the rounding makes the same fault whatever kernel runs, so
    that a limit can be shown to reject it."""
    matmul = torch.matmul
    with mock.patch.object(torch, "matmul",
                           lambda a, b: matmul(to_tf32(a), to_tf32(b))):
        yield


class SharedQuantization:
    """The int8 inputs of every W8A8 product of a BERT forward
    (``models/bert.py``'s ``qmatmul``), shared with the forwards after
    it.

    Within ``applied()``, while ``records`` is empty each product records
    its float input, its int8 rows and scales and its int32 sums (on the
    CPU) and returns what ``qmatmul`` returns. Later, each product
    compares its own float input with the recorded one (``input_err``:
    the largest max |d| / max |want| over the products), sums the
    RECORDED int8 rows with its own weights, checks the int32 sums
    against the recorded ones (``sums_equal``, over every product of
    every layer) and dequantizes with the recorded scales. An activation
    that rounds to the other int8 value on the two devices then carries
    into no later layer, and what is left between the two forwards is
    their float work."""

    def __init__(self):
        self.records, self.input_err, self.sums_equal = [], 0.0, True

    @contextlib.contextmanager
    def applied(self):
        from .models import bert
        from .ops.qlinear import quantize_rows
        from .ops.quant import int_mm

        record, replay = not self.records, iter(self.records)
        self.input_err, self.sums_equal = 0.0, True

        def qmatmul(x, wq, ws):
            if record:
                xq, xs = quantize_rows(x)
                acc = int_mm(xq, wq, ws.shape[0])
                self.records.append(tuple(t.cpu() for t in (x, xq, xs, acc)))
            else:
                want, xq, xs, want_acc = next(replay)
                self.input_err = max(self.input_err, relative_errors(
                    {"x": x.float().cpu()}, {"x": want.float()})["x"])
                xq, xs = xq.to(x.device), xs.to(x.device)
                acc = int_mm(xq, wq, ws.shape[0])
                self.sums_equal &= torch.equal(acc.cpu(), want_acc)
            return acc.float() * (xs * ws)

        with mock.patch.object(bert, "qmatmul", qmatmul):
            yield self


def train_step_errors(got, want, lr):
    """How far one ``train_step_record`` is from another: the loss's
    relative error; per tensor, max |d| / max |want| of the gradients,
    Adam's moments and the BN statistics (``relative_errors``); the
    share of the updated parameters' elements that differ by more than
    lr / 100 (a first Adam step moves each element by less than lr on
    either side, so their largest difference is below 2 lr whatever the
    gradients). The attention model's score bias's gradient is zero in
    exact arithmetic (the softmax ignores a shift of every score), so
    its gradient and moments are left out of the relative errors and its
    largest gradient on each side is returned as ``score_bias_grad``
    (empty for the baseline)."""
    out = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "score_bias_grad": [r["grads"][SCORE_BIAS].abs().max().item()
                               for r in (got, want)
                               if SCORE_BIAS in r["grads"]]}
    for key in ("grads", "exp_avg", "exp_avg_sq", "bn"):
        out[key] = relative_errors(
            {n: t for n, t in got[key].items() if n != SCORE_BIAS},
            {n: t for n, t in want[key].items() if n != SCORE_BIAS})
    steps = [(got["params"][n] - p).abs() / lr
             for n, p in want["params"].items()]
    out["step_share_beyond"] = (sum(int((d > 1e-2).sum()) for d in steps)
                                / sum(d.numel() for d in steps))
    return out
