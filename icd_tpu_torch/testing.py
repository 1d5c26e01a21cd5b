"""Helpers of the card tests and ``chip_smoke.py``: random decoders that
finish their captions, seeded captions, one train step of either model
family recorded for comparison across devices, and two ways to make a
second device take the first one's discrete choices (the attention's
relu branches, the W8A8 BERT's int8 roundings) so that the comparison
sees only their float work, and a tracer of K2's f32 splits from its
plain version against a float64 arbiter (``trace_k2_splits``).

A random decoder never emits ``<end>`` among thousands of near-equal
logits, so every beam search would run to its step limit. ``steer_end``
gives one LSTM unit the job of counting steps and makes it the only
input of the ``<end>`` logit, so captions end after a number of steps
that depends on the image.

``bn_epilogue_sites`` lists K3's launches in a trunk's forward, and
``bn_epilogue_case`` makes one site's operands from a seed;
``int8_epilogue_sites`` and ``int8_epilogue_case`` do the same for K4
on the static-int8 trunk.

``codec_corpus`` is a seeded set of JPEGs that the port's encoder writes
(each subsampling, progressive, restart markers, grey, odd sizes,
640x480); ``CODEC_CORPUS_DIGEST`` is the ``pixel_digest`` of PIL's
decode of it, which ``tests/test_torch_jpeg.py`` proves and
``chip_smoke.py`` holds the card machine's build of the codec to.
"""

import contextlib
import copy
import hashlib
import math
from unittest import mock

import numpy as np
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


BN_EPILOGUE_SETUPS = ("bf16_keep", "bf16_cast", "f32")


def bn_epilogue_sites(batch=64):
    """K3's launches in one eval-mode forward of ResNet-101 at 224 x 224
    images, in order: (NHWC shape, form), form 0 for relu(bn(x)), 1 with
    an identity residual, 2 with the downsample's BN. Traced on the meta
    device."""
    from .models import resnet

    sites = []

    def recording(x, bn, compute_dtype=None, residual=None, shortcut=None):
        form = 0 if residual is None and shortcut is None else (
            1 if residual is not None else 2)
        sites.append((tuple(x.shape), form))
        return x

    plain = resnet.bn_relu
    resnet.bn_relu = recording
    try:
        with torch.device("meta"):
            resnet.resnet_forward(resnet.ResNet(),
                                  torch.empty(batch, 224, 224, 3))
    finally:
        resnet.bn_relu = plain
    return sites


def random_bn(c, generator, setup, device=None):
    """(BN of ``c`` channels, compute_dtype) with random statistics, scale
    and bias, stored as ``setup`` says: ``bf16_keep`` the bf16 serving
    trunk (parameters bf16, statistics f32, ``cast_keep_bn_stats``),
    ``bf16_cast`` a trunk cast whole to bf16, ``f32`` all f32."""
    from .models.resnet import BatchNorm

    bn = BatchNorm(c)
    with torch.no_grad():
        bn.mean.copy_(torch.randn(c, generator=generator))
        bn.var.copy_(torch.rand(c, generator=generator) * 4 + 0.01)
        bn.scale.copy_(1 + 0.5 * torch.randn(c, generator=generator))
        bn.bias.copy_(0.5 * torch.randn(c, generator=generator))
    bn = bn.requires_grad_(False).to(device)
    if setup == "f32":
        return bn, None
    if setup == "bf16_cast":
        return bn.to(torch.bfloat16), torch.bfloat16
    for p in bn.parameters():
        p.data = p.data.to(torch.bfloat16)
    return bn, torch.bfloat16


def bn_epilogue_case(shape, form, generator, setup, device=None):
    """K3's operands at one site: (x, bn, compute_dtype, residual,
    shortcut) for ``models.resnet.bn_relu``, with ``shortcut`` = (s, bn')
    in form 2; activations N(0, 4) in the setup's activation dtype."""
    dtype = torch.float32 if setup == "f32" else torch.bfloat16

    def act():
        return (2 * torch.randn(shape, generator=generator)).to(
            device=device, dtype=dtype)

    c = shape[-1]
    bn, compute_dtype = random_bn(c, generator, setup, device)
    x = act()
    residual = act() if form == 1 else None
    shortcut = None
    if form == 2:
        s = act()
        shortcut = (s, random_bn(c, generator, setup, device)[0])
    return x, bn, compute_dtype, residual, shortcut


def int8_tree(resnet, device=None):
    """An int8 serving tree of ``resnet``'s shapes (``quantize_resnet``'s
    layout) with empty values: for tracing the int8 trunk on the meta
    device."""
    def site(conv):
        o, i, kh, kw = conv.shape
        return {"wq": torch.empty(kh, kw, i, o, dtype=torch.int8,
                                  device=device),
                "scale": torch.empty(o, device=device),
                "bias": torch.empty(o, device=device),
                "inv_in": torch.empty((), device=device)}

    tree = {"stem": site(resnet.stem.conv), "layers": []}
    for blocks in resnet.layers:
        tree["layers"].append([])
        for b in blocks:
            qb = {"conv1": site(b.conv1), "conv2": site(b.conv2),
                  "conv3": site(b.conv3)}
            if b.downsample is not None:
                qb["downsample"] = site(b.downsample.conv)
            tree["layers"][-1].append(qb)
    return tree


def int8_epilogue_sites(batch=64):
    """K4's launches in one forward of the static-int8 ResNet-101 at 224 x
    224 images, in order: (NHWC shape, residual, s8 output), residual 0
    for none, 1 for an identity shortcut, 2 for a downsample; s8 False
    at the last block, which writes the trunk's float output. Traced on
    the meta device."""
    from .models import resnet, resnet_int8

    sites = []

    def recording(acc, site, inv_next=None, in_inv=None, downsample=None,
                  other=None, out_dtype=None):
        residual = 1 if in_inv is not None else 2 if downsample else 0
        sites.append((tuple(acc.shape), residual, inv_next is not None))
        return torch.empty(acc.shape, device=acc.device, dtype=(
            torch.int8 if inv_next is not None else out_dtype))

    plain = resnet_int8._epilogue
    resnet_int8._epilogue = recording
    try:
        with torch.device("meta"):
            resnet_int8.resnet_int8_forward(int8_tree(resnet.ResNet()),
                                            torch.empty(batch, 224, 224, 3))
    finally:
        resnet_int8._epilogue = plain
    return sites


def int8_epilogue_case(shape, residual, s8, generator, device=None):
    """K4's operands at one site: (acc, terms, other), ``terms`` the
    plain ``(scale, bias, inv_next, in_inv, ds_scale, ds_bias)``
    (``inv_next`` None unless ``s8``). The int32 sums are at the trunk's
    scale (|acc| < 2**20) with one in 16 scaled past 2**24, where their
    cast to f32 rounds; scale and bias put most outputs inside the s8
    range and some past it, so the clamp is taken too."""
    c = shape[-1]

    def sums():
        acc = torch.randint(-2 ** 20, 2 ** 20, shape, generator=generator,
                            dtype=torch.int32)
        big = torch.randint(0, 16, shape, generator=generator) == 0
        return torch.where(big, acc * 97, acc).to(device)

    def channel(lo, hi):
        return (lo + (hi - lo) * torch.rand(c, generator=generator)).to(
            device)

    def single(lo, hi):
        return torch.tensor(lo + (hi - lo) * torch.rand(
            (), generator=generator).item(), device=device)

    acc = sums()
    scale = channel(0.2, 2.0) * (100.0 / 2 ** 20)
    bias = channel(-20.0, 20.0)
    inv_next = single(0.3, 3.0) if s8 else None
    in_inv = ds_scale = ds_bias = other = None
    if residual == 1:
        in_inv = single(0.5, 5.0)
        other = torch.randint(-127, 128, shape, generator=generator,
                              dtype=torch.int8).to(device)
    elif residual == 2:
        ds_scale = channel(0.2, 2.0) * (100.0 / 2 ** 20)
        ds_bias = channel(-20.0, 20.0)
        other = sums()
    return acc, (scale, bias, inv_next, in_inv, ds_scale, ds_bias), other


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


# ---------------------------------------------------------------------------
# The multi-chip path: programs for the ranks of ``parallel.run_ranks``
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def mesh_train(mesh, family, encoder, decoder, batches, lr=1e-3,
               grad_clip=5.0, dropout=0.0, alpha_c=1.0, compute_dtype=None,
               qresnet=None, fine_tune_embedding=True, use_bert=False,
               opt_state=None):
    """Train steps of ``family`` ("baseline" or "attention") over
    ``batches`` on ``mesh`` (None: this process alone), as the train
    functions run them: ``make_adam`` (Adam at ``lr`` from ``opt_state``,
    the decoder cut to its vocab shards on the mesh), the family's
    ``make_train_step`` and each rank's rows of every batch. A batch is
    a dict of global numpy arrays: "imgs", "captions" (<pad> 0) and,
    with ``use_bert``, "embeddings"; the attention model decodes the
    padded length - 1. The dropout mask comes from a generator seeded 1
    on the modules' device. Returns the global losses and, gathered to
    full vocab, the decoder and Adam's state as numpy trees
    (``params.decoder_to_jax``, ``adam_state_to_jax``) and the trunk's
    BN statistics by buffer name."""
    from types import SimpleNamespace

    from .params import adam_state_to_jax, decoder_to_jax
    from .parallel.mesh import shard_batch
    from .parallel.vocab import unshard_decoder
    from .training import attention, baseline
    from .training.common import make_adam

    device = decoder.lstm.weight_ih.device
    args = SimpleNamespace(encoder_lr=lr, decoder_lr=lr, use_bert=use_bert,
                           fine_tune_embedding=fine_tune_embedding)
    optimizer = make_adam(args, encoder, decoder, opt_state, mesh=mesh)
    if family == "baseline":
        step = baseline.make_train_step(encoder, decoder, optimizer, 0,
                                        grad_clip, compute_dtype, qresnet,
                                        mesh)
    else:
        step = attention.make_train_step(encoder, decoder, optimizer,
                                         alpha_c, dropout, grad_clip,
                                         compute_dtype, qresnet, mesh)
    generator = torch.Generator(device).manual_seed(1)
    losses = []
    for batch in batches:
        n = len(batch["captions"])
        local = {key: torch.from_numpy(x).to(device) for key, x in (
            batch if mesh is None else shard_batch(batch, mesh)).items()}
        if family == "baseline":
            loss = step(local["imgs"], local["captions"], n)
        else:
            caps = local["captions"]
            lengths = torch.full((len(caps),), caps.shape[1] - 1,
                                 device=device)
            loss = step(local["imgs"], caps, lengths, generator,
                        local.get("embeddings"), n)
        losses.append(float(loss))
    if mesh is not None:
        unshard_decoder(decoder, mesh, optimizer)
    return dict(losses=losses, decoder=decoder_to_jax(decoder),
                adam=adam_state_to_jax(optimizer, decoder),
                bn={name: buf.cpu().numpy() for name, buf
                    in encoder.resnet.named_buffers()})


def vocab_grads(decoder, family, inputs, mesh=None):
    """The gradients of every decoder parameter (a numpy tree keyed as
    ``params.decoder_to_jax``) of one teacher-forced loss on ``inputs``
    (the whole batch on every rank: "feats" or "grid", "captions"), the
    decoder cut to its vocab shards on ``mesh`` and their gradients
    gathered back to the full vocabulary. The loss is the family's
    train CE (plus the attention regulariser) of the gathered logits,
    replicated on every model rank, as the JAX package computes it."""
    import torch.distributed as dist

    from .models.attention import attention_decoder_forward
    from .models.baseline import baseline_decoder_forward
    from .params import _put, decoder_leaves
    from .parallel.mesh import decoder_param_specs
    from .parallel.vocab import shard_decoder
    from .training.common import (cross_entropy,
                                  doubly_stochastic_regularizer,
                                  pad_cross_entropy)

    specs = decoder_param_specs(decoder)
    if mesh is not None:
        shard_decoder(decoder, mesh)
    caps = inputs["captions"].long()
    if family == "baseline":
        logits = baseline_decoder_forward(decoder, inputs["feats"], caps)
        loss = pad_cross_entropy(logits, caps, 0)
    else:
        lengths = torch.full((len(caps),), caps.shape[1] - 1,
                             device=caps.device)
        logits, alphas = attention_decoder_forward(decoder, inputs["grid"],
                                                   caps, lengths)
        loss = (cross_entropy(logits, caps[:, 1:], lengths)
                + doubly_stochastic_regularizer(alphas, 1.0))
    loss.backward()
    names = {id(p): n for n, p in decoder.named_parameters()}
    out = {}
    for path, param, transposed in decoder_leaves(decoder):
        grad = param.grad
        if mesh is not None and specs[names[id(param)]] is not None:
            parts = [torch.empty_like(grad)
                     for _ in range(mesh.shape["model"])]
            dist.all_gather(parts, grad.contiguous(), group=mesh.model_group)
            grad = torch.cat(parts)
        grad = grad.cpu().numpy()
        _put(out, path, grad.T.copy() if transposed else grad)
    return dict(loss=float(loss.detach()), grads=out)


def _case_models(case, device):
    from .params import decoder_from_jax, encoder_from_jax, qresnet_from_jax

    encoder = encoder_from_jax(case["encoder"]).to(device)
    decoder = decoder_from_jax(case["decoder"]).to(device)
    qresnet = case.get("qresnet")
    if qresnet is not None:
        from .models.resnet_int8 import tree_to

        qresnet = tree_to(qresnet_from_jax(qresnet), device)
    return encoder, decoder, qresnet


def _train_case(mesh, case, device):
    encoder, decoder, qresnet = _case_models(case, device)
    return mesh_train(mesh, case["family"], encoder, decoder,
                      case["batches"], qresnet=qresnet, **case["options"])


def _bn_case(mesh, case, device):
    from .models.resnet import BatchNorm, batch_norm_train
    from .parallel.mesh import batch_layout

    x = torch.from_numpy(case["x"]).to(device)
    bn = BatchNorm(x.shape[-1]).to(device)
    with torch.no_grad():
        for key, value in case["bn"].items():
            getattr(bn, key).copy_(torch.from_numpy(value))
    rows, group = batch_layout(mesh, len(x))
    with torch.no_grad():
        y, stats = batch_norm_train(x[rows], bn, group=group)
    return dict(y=y.cpu().numpy(), mean=stats["mean"].cpu().numpy(),
                var=stats["var"].cpu().numpy())


def _vocab_grads_case(mesh, case, device):
    from .params import decoder_from_jax

    inputs = {k: torch.from_numpy(v).to(device)
              for k, v in case["inputs"].items()}
    return vocab_grads(decoder_from_jax(case["decoder"]).to(device),
                       case["family"], inputs, mesh)


def _captioner_case(mesh, case, device):
    """The three sharded captioners in f32 on ``case``'s trees and
    images; numpy outputs."""
    from .decoding.serve import (make_sharded_attention_captioner,
                                 make_sharded_beam_captioner,
                                 make_sharded_captioner)
    from .params import decoder_from_jax, encoder_from_jax

    imgs = case["imgs"]
    start, end = case["start_id"], case["end_id"]
    f32 = torch.float32
    out = {}
    if "baseline_encoder" in case:
        enc = encoder_from_jax(case["baseline_encoder"])
        dec = decoder_from_jax(case["baseline_decoder"])
        out["baseline"] = make_sharded_captioner(
            enc, dec, start, end, mesh, max_len=6, compute_dtype=f32)(imgs)
        out["baseline_int8"] = make_sharded_captioner(
            enc, dec, start, end, mesh, max_len=6, compute_dtype=f32,
            int8=True, act_maxes=case["act_maxes"], int8_decoder=True)(imgs)
    enc = encoder_from_jax(case["encoder"])
    dec = decoder_from_jax(case["decoder"])
    out["greedy"] = make_sharded_attention_captioner(
        enc, dec, start, end, mesh, max_len=case["max_len"],
        compute_dtype=f32)(imgs)
    out["beam"] = make_sharded_beam_captioner(
        enc, dec, start, end, mesh, beam_size=3, compute_dtype=f32)(imgs)
    return {k: tuple(_numpy_tree(x) for x in v) if isinstance(v, tuple)
            else _numpy_tree(v) for k, v in out.items()}


def _ckpt_case(mesh, case, device):
    """Steps on the mesh, the checkpoint of the gathered shards written by
    global rank 0 under ``case["root"]``, then every rank resumes from
    the file onto the mesh and steps on."""
    import os
    from types import SimpleNamespace

    import torch.distributed as dist

    from .checkpoint import load_checkpoint, save_checkpoint, \
        unpack_checkpoint
    from .params import decoder_from_jax, encoder_from_jax, encoder_to_jax

    encoder, decoder, _ = _case_models(case, device)
    batches, options = case["batches"], case["options"]
    first = mesh_train(mesh, case["family"], encoder, decoder,
                       batches[:-1], **options)
    os.environ["ICD_TPU_ROOT"] = case["root"]
    if dist.get_rank() == 0:
        save_checkpoint(SimpleNamespace(model_name="mesh",
                                        model=case["family"],
                                        grad_clip=options.get("grad_clip",
                                                              5.0)),
                        0, encoder_to_jax(encoder), first["decoder"], None,
                        first["adam"], {"epoch_losses": [first["losses"]]})
    dist.barrier()
    _, enc_tree, dec_tree, _, opt_state, _ = unpack_checkpoint(
        load_checkpoint(name="mesh_0.ckpt", verbose=False))
    resumed = mesh_train(
        mesh, case["family"], encoder_from_jax(enc_tree).to(device),
        decoder_from_jax(dec_tree).to(device), batches[-1:],
        opt_state=opt_state, **options)
    return dict(first=first, resumed=resumed)


def _cached_case(mesh, case, device):
    """The train loop's staging (``training.common.stage_batches``) of
    ``case["batches"]`` (with ``img_ids``) into baseline steps on the
    mesh, without and with the device image cache (a budget of
    ``case["budget_gb"]``; each rank keeps the whole buffer and gathers
    its own rows of ``idx``): the global losses of each run and the
    cache's hits and misses."""
    from types import SimpleNamespace

    from .data.pipeline import DeviceImageCache
    from .training import baseline
    from .training.common import make_adam, stage_batches

    out = {}
    for label in ("direct", "cached"):
        encoder, decoder, _ = _case_models(case, device)
        args = SimpleNamespace(encoder_lr=1e-3, decoder_lr=1e-3,
                               use_bert=False, fine_tune_embedding=True)
        optimizer = make_adam(args, encoder, decoder, None, mesh=mesh)
        run = baseline.batch_step(baseline.make_train_step(
            encoder, decoder, optimizer, 0, 5.0, mesh=mesh), device, mesh)
        cache = buf = None
        batches = [dict(b) for b in case["batches"]]
        if label == "cached":
            cache = DeviceImageCache(case["budget_gb"],
                                     batches[0]["imgs"].shape[1:],
                                     len(batches[0]["captions"]))
            buf = cache.init_buffer(device)
        else:
            for b in batches:
                b.pop("img_ids")
        out[label] = [float(run(b)) for b in stage_batches(
            batches, device, mesh, img_cache=cache, buf=buf)]
        if cache is not None:
            out["hits"], out["misses"] = cache.hits, cache.misses
    return out


MESH_CASES = {"train": _train_case, "bn": _bn_case, "ckpt": _ckpt_case,
              "vocab_grads": _vocab_grads_case,
              "captioners": _captioner_case, "cached": _cached_case}


def run_mesh_cases(rank, world, cases, device="cpu"):
    """``parallel.run_ranks``' program of the tests: every rank makes the
    mesh of each case in ``cases`` (a list of dicts with "kind", "name",
    "n_data", "n_model" and the kind's inputs as numpy) over the first
    ranks of the world, and the ranks inside it run the case
    (``MESH_CASES``); on a card f32 runs with TF32 off. Returns {name:
    this rank's result, None outside the mesh}."""
    from .parallel.mesh import make_mesh

    if torch.device(device).type == "cuda":
        f32_products()
    out = {}
    for case in cases:
        mesh = make_mesh(case["n_data"], case["n_model"], device=device)
        out[case["name"]] = (None if mesh.coords is None else
                             MESH_CASES[case["kind"]](mesh, case, device))
    return out


# ---------------------------------------------------------------------------
# A skeleton of the reference's classes, for the .pth.tar paths
# ---------------------------------------------------------------------------

# The reference repository's module paths, parameter names and the
# constructors that ``export.export_reference_checkpoint`` calls
# (models/encoder.py, models/baseline.py, models/attention.py,
# vocabulary.py): enough to build and pickle whole-module checkpoints
# as the reference's ``save_checkpoint`` writes them, nothing more.
_SKELETON = {
    "models/__init__.py": "",
    "models/encoder.py": '''
import torch.nn as nn
import torchvision


def _load_resnet101_model():
    return torchvision.models.resnet101(pretrained=False)


class Encoder(nn.Module):
    def __init__(self, embed_size):
        super().__init__()
        resnet = _load_resnet101_model()
        self.resnet = nn.Sequential(*list(resnet.children())[:-1])
        self.embed = nn.Linear(resnet.fc.in_features, embed_size)


class EncoderAttention(nn.Module):
    def __init__(self):
        super().__init__()
        resnet = _load_resnet101_model()
        self.resnet = nn.Sequential(*list(resnet.children())[:-2])
        self.adaptive_pool = nn.AdaptiveAvgPool2d((14, 14))
''',
    "models/baseline.py": '''
import torch.nn as nn


class BaselineDecoderParams:
    vocab_size = None
    embed_size = 512
    hidden_size = 512
    num_layers = 1
    max_seq_length = 20


class BaselineDecoder(nn.Module):
    def __init__(self, params):
        super().__init__()
        self.embedding = nn.Embedding(params.vocab_size, params.embed_size)
        self.lstm = nn.LSTM(params.embed_size, params.hidden_size,
                            params.num_layers, batch_first=True)
        self.linear = nn.Linear(params.hidden_size, params.vocab_size)
        self.max_seq_length = params.max_seq_length
''',
    "models/attention.py": '''
import torch.nn as nn

from vocabulary import Vocabulary


class AttentionDecoderParams:
    attention_dim = 512
    embed_size = 512
    decoder_dim = 512
    encoder_dim = {encoder_dim}
    dropout = 0.5
    use_bert = False
    vocab = None


class Attention(nn.Module):
    def __init__(self, encoder_dim, decoder_dim, attention_dim):
        super().__init__()
        self.enc_att = nn.Linear(encoder_dim, attention_dim)
        self.dec_att = nn.Linear(decoder_dim, attention_dim)
        self.full_att = nn.Linear(attention_dim, 1)
        self.relu = nn.ReLU()
        self.softmax = nn.Softmax(dim=1)


class AttentionDecoder(nn.Module):
    def __init__(self, device, params):
        super().__init__()
        assert isinstance(params.vocab, Vocabulary)
        self.device = device
        self.vocab = params.vocab
        self.vocab_size = len(params.vocab)
        self.encoder_dim = params.encoder_dim
        self.attention_dim = params.attention_dim
        self.embed_size = params.embed_size
        self.decoder_dim = params.decoder_dim
        self.use_bert = params.use_bert
        if self.use_bert:
            from pytorch_pretrained_bert import BertModel, BertTokenizer

            self.bert_model = BertModel.from_pretrained("bert-base-uncased")
            self.tokenizer = BertTokenizer.from_pretrained(
                "bert-base-uncased")
            for p in self.bert_model.parameters():
                p.requires_grad = False
        self.attention = Attention(params.encoder_dim, params.decoder_dim,
                                   params.attention_dim)
        self.embedding = nn.Embedding(self.vocab_size, params.embed_size)
        self.dropout = nn.Dropout(p=params.dropout)
        self.decode_step = nn.LSTMCell(params.embed_size + params.encoder_dim,
                                       params.decoder_dim, bias=True)
        self.h_lin = nn.Linear(params.encoder_dim, params.decoder_dim)
        self.c_lin = nn.Linear(params.encoder_dim, params.decoder_dim)
        self.f_beta = nn.Linear(params.decoder_dim, params.encoder_dim)
        self.sigmoid = nn.Sigmoid()
        self.fc = nn.Linear(params.decoder_dim, self.vocab_size)
''',
    "vocabulary.py": '''
from pycocotools.coco import COCO  # noqa: F401  (the reference's import)

PAD_TOKEN = "<pad>"
START_TOKEN = "<start>"
END_TOKEN = "<end>"
UNK_TOKEN = "<unk>"


class Vocabulary:
    def __init__(self):
        self.w2i = {{}}
        self.i2w = {{}}
        self.idx = 0

    def add_word(self, word):
        if word not in self.w2i:
            self.w2i[word] = self.idx
            self.i2w[self.idx] = word
            self.idx += 1

    def __call__(self, word):
        if word not in self.w2i:
            return self.w2i[UNK_TOKEN]
        return self.w2i[word]

    def __len__(self):
        return len(self.w2i)
''',
}

# A torchvision whose resnet101() is a small ResNet (the reference's
# layout, torchvision's child order): the CPU tests' stand-in for
# ResNet-101, found on the skeleton's root before any other torchvision.
_MINI_TORCHVISION = '''
import torch.nn as nn

DEPTHS = {depths}
WIDTHS = {widths}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample
        self.stride = stride


class ResNet(nn.Module):
    def __init__(self, block, layers, widths=WIDTHS, num_classes=1000):
        super().__init__()
        self.inplanes = widths[0]
        self.conv1 = nn.Conv2d(3, widths[0], 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(widths[0])
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        for i, (depth, planes) in enumerate(zip(layers, widths)):
            setattr(self, "layer{{}}".format(i + 1), self._make_layer(
                block, planes, depth, 1 if i == 0 else 2))
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(widths[-1] * 4, num_classes)

    def _make_layer(self, block, planes, depth, stride):
        downsample = None
        if stride != 1 or self.inplanes != planes * 4:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * 4, 1, stride=stride,
                          bias=False),
                nn.BatchNorm2d(planes * 4))
        blocks = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * 4
        for _ in range(1, depth):
            blocks.append(block(self.inplanes, planes))
        return nn.Sequential(*blocks)


def resnet101(pretrained=False):
    return ResNet(Bottleneck, DEPTHS)
'''


def write_reference_skeleton(root, depths=None, widths=None):
    """Write the skeleton of the reference's classes under ``root``, a
    directory to use as a ``--reference_root``. With ``depths`` and
    ``widths`` it also writes a ``torchvision`` package there whose
    ``resnet101()`` builds a ResNet of those, and the attention
    decoder's default ``encoder_dim`` is that trunk's (``widths[-1] *
    4``); else the trunk is torchvision's (or ``compat``'s stand-in's)
    ResNet-101 and ``encoder_dim`` 2048. Returns ``root``."""
    import os

    files = dict(_SKELETON)
    encoder_dim = 2048
    if depths is not None:
        files["torchvision/__init__.py"] = "from . import models\n"
        files["torchvision/models/__init__.py"] = (
            "from . import resnet\nfrom .resnet import ResNet, resnet101\n")
        files["torchvision/models/resnet.py"] = _MINI_TORCHVISION.format(
            depths=tuple(depths), widths=tuple(widths))
        encoder_dim = widths[-1] * 4
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if rel == "models/attention.py":
            text = text.format(encoder_dim=encoder_dim)
        elif rel == "vocabulary.py":
            text = text.format()
        with open(path, "w") as f:
            f.write(text.lstrip("\n"))
    return root


# (name, (width, height), grey, encode keywords) of codec_corpus.
CODEC_CORPUS = [
    ("420_q75", (640, 480), False, {}),
    ("420_q90", (640, 480), False, dict(quality=90)),
    ("422_q75", (640, 480), False, dict(subsampling="4:2:2")),
    ("444_q95", (640, 480), False, dict(subsampling="4:4:4", quality=95)),
    ("440_q75", (640, 480), False, dict(subsampling="4:4:0")),
    ("420_progressive", (640, 480), False, dict(progressive=True)),
    ("444_progressive", (640, 480), False,
     dict(subsampling="4:4:4", quality=90, progressive=True)),
    ("420_restart_blocks", (640, 480), False,
     dict(restart_marker_blocks=4)),
    ("420_progressive_restart_rows", (640, 480), False,
     dict(progressive=True, restart_marker_rows=2)),
    ("420_optimize", (640, 480), False, dict(optimize=True)),
    ("grey", (640, 480), True, {}),
    ("grey_progressive", (17, 9), True, dict(progressive=True)),
    ("grey_1x1", (1, 1), True, {}),
    ("420_1x1", (1, 1), False, {}),
    ("420_17x9", (17, 9), False, {}),
    ("440_17x9", (17, 9), False, dict(subsampling="4:4:0")),
    ("422_17x9_progressive", (17, 9), False,
     dict(subsampling="4:2:2", progressive=True)),
    ("444_9x17", (9, 17), False, dict(subsampling="4:4:4")),
    ("420_481x641_restart", (481, 641), False,
     dict(restart_marker_blocks=7)),
    ("440_33x47_progressive", (33, 47), False,
     dict(subsampling="4:4:0", progressive=True)),
    ("420_3x5", (3, 5), False, {}),
    ("422_4x4_q5", (4, 4), False, dict(subsampling="4:2:2", quality=5)),
    ("420_64x48_q5", (64, 48), False, dict(quality=5)),
    ("444_64x48_q100", (64, 48), False,
     dict(subsampling="4:4:4", quality=100)),
]
CODEC_CORPUS_DIGEST = (
    "e991835b1f32e7c5f097609769838fbf7807a52afa3580d13b46d0ea2735af81")


def codec_corpus(seed=13):
    """[(name, JPEG bytes)] of ``CODEC_CORPUS``: low-frequency content
    (a seeded 1/8-size array resized BILINEAR) plus seeded noise of
    +-24 levels, encoded by the port's codec."""
    from .native import jpeg

    rng = np.random.default_rng(seed)
    out = []
    for name, (w, h), grey, kwargs in CODEC_CORPUS:
        small = rng.integers(0, 256, (max(1, h // 8), max(1, w // 8), 3),
                             dtype=np.uint8)
        img = jpeg.resize_bilinear(small, w, h).astype(np.int16)
        img += rng.integers(-24, 25, img.shape, dtype=np.int16)
        img = np.clip(img, 0, 255).astype(np.uint8)
        out.append((name, jpeg.encode(img[..., 0] if grey else img,
                                      **kwargs)))
    return out


def pixel_digest(arrays):
    """sha256 over each (H, W, 3) uint8 array's shape and bytes."""
    digest = hashlib.sha256()
    for arr in arrays:
        digest.update(repr(tuple(arr.shape)).encode())
        digest.update(np.ascontiguousarray(arr, np.uint8).tobytes())
    return digest.hexdigest()


# K2's splits from its plain version, traced against a float64 arbiter.

def rank_order(flat, scores, valid):
    """(B, k) flat candidate indices in ``lax.top_k`` order (score
    descending, index ascending), the slots ``>= valid`` (B,) last."""
    k = flat.shape[1]
    scores = torch.where(torch.arange(k, device=flat.device) < valid[:, None],
                         scores.double(), -math.inf)
    by_index = torch.argsort(flat, dim=1, stable=True)
    by_score = torch.argsort(scores.gather(1, by_index), dim=1,
                             descending=True, stable=True)
    return flat.gather(1, by_index.gather(1, by_score))


def plain_step_record(ops, k, start_id, end_id, steps, images,
                      acc=torch.float32, replay=None):
    """K2's plain version (``ops.fused_beam._search_plain``) for ``steps``
    steps, sums and state in ``acc``: ``{"choices": {t: (B, k) flat
    indices of step t's top-k in rank order}, "cands": {t: (len(images),
    k * V) the candidates of ``images`` at step t}}`` for each step run.
    With ``replay`` (another run's choices) each step takes those instead
    of its own top-k: the float64 arbiter follows the f32 run's beams, so
    its candidates are the same beams' scores."""
    from .decoding.beam import _top_k
    from .ops.fused_beam import _search_plain

    out = {"choices": {}, "cands": {}}

    def top_k(flat, n):
        t = len(out["choices"]) + 1
        out["cands"][t] = flat[images].clone()
        if replay is None:
            values, idx = _top_k(flat, n)
        else:
            idx = replay[t]
            values = flat.gather(1, idx)
        out["choices"][t] = idx.clone()
        return values, idx

    _search_plain(ops, k, start_id, end_id, steps, acc=acc, top_k=top_k)
    return out


def k2_step_record(ops, k, start_id, end_id, steps, images):
    """K2 stopped after each step t = 1..``steps`` (a launch each) and read
    through its workspace views (``ops.fused_beam._scratch``):
    ``{"choices": {t: (B, k) flat indices of K2's choice in rank order},
    "cands": {t: (len(images), k * V) f32 candidates of ``images``}},
    "consistent": {t: (B,) bool}, "prefix_equal": bool}``.

    A step's candidates are rebuilt as phase E forms them, (logits - lse)
    + the running scores left by the launch stopped after t - 1, NEG_INF
    on rows not live. ``consistent``: K2's stored scores of its choice
    equal those candidates bit for bit, and its choice is their top-k in
    ``lax.top_k`` order (its cutoff prefilter dropped no candidate that
    belongs there). ``prefix_equal``: every stopped launch's parents and
    alphas equal a full launch's for the steps it ran, bit for bit, on a
    grid of the same blocks."""
    from .decoding.beam import NEG_INF, _top_k
    from .ops import fused_beam

    full = fused_beam._launch(ops, k, start_id, end_id, steps)
    blocks = fused_beam.beam_search_fused.grid_blocks
    b, v = ops["enc"].shape[0], ops["emb"].shape[0]
    slots = torch.arange(k, device=ops["enc"].device)
    cum = torch.zeros((b, k), dtype=torch.float32, device=slots.device)
    valid = torch.full((b,), k, dtype=torch.long, device=slots.device)
    out = {"choices": {}, "cands": {}, "consistent": {},
           "prefix_equal": True}
    for t in range(1, steps + 1):
        raw = fused_beam._launch(ops, k, start_id, end_id, t)
        out["prefix_equal"] &= (
            fused_beam.beam_search_fused.grid_blocks == blocks
            and torch.equal(raw["parent"][1:t + 1], full["parent"][1:t + 1])
            and torch.equal(raw["alpha"][1:t + 1], full["alpha"][1:t + 1]))
        sc = raw["scratch"]
        live = (slots == 0) if t == 1 else slots < valid[:, None]
        cand = torch.where(
            live.expand(b, k)[..., None],
            (sc["logits"].float().view(b, k, v) - sc["lse"].view(b, k, 1))
            + cum[..., None], NEG_INF).view(b, k * v)
        flat = raw["parent"][t].long() * v + sc["words"].view(b, k).long()
        score = sc["cum"].view(b, k)
        choice = rank_order(flat, score, valid)
        own = _top_k(cand, k)[1]
        ok = slots < valid[:, None]
        out["consistent"][t] = (
            ((choice == own) | ~ok).all(dim=1)
            & ((cand.gather(1, flat) == score) | ~ok).all(dim=1))
        out["choices"][t] = choice
        out["cands"][t] = cand[images].clone()
        cum = score.clone()
        valid = sc["kact"].long().clone()
    return out


def explain_splits(k2, plain, arbiter, images, k, v, end_id):
    """For each of ``images``: the first step whose choice differs between
    K2 and its f32 plain version (records of ``k2_step_record`` and
    ``plain_step_record``; ``arbiter``'s from the float64 replay), and
    there each rank whose candidate differs, as a pair (K2's, the plain
    version's) of (prev, word): their scores in all three, the f64 gap
    between them, and each f32 version's error against f64 on the pair
    (the sum over its two candidates). A pair is explained when the gap
    is no larger than the two errors together: rounding alone can then
    order it either way. A split is explained when every pair is and K2
    was consistent (its choice the top-k of its own scores) up to it.
    Returns one dict a split, with ``step`` None where no choice
    differs within the steps recorded."""
    steps = sorted(plain["choices"])
    out = []
    for n, img in enumerate(images):
        valid = k
        rec = dict(image=int(img), step=None, explained=False)
        for t in steps:
            got, want = k2["choices"][t][img], plain["choices"][t][img]
            if not torch.equal(got[:valid], want[:valid]):
                rec.update(_split_pairs(k2, plain, arbiter, t, n, got, want,
                                        valid, v))
                rec["k2_consistent"] = all(
                    bool(k2["consistent"][u][img]) for u in steps if u <= t)
                rec["explained"] = rec["k2_consistent"] and all(
                    p["explained"] for p in rec["pairs"])
                break
            valid = int(sum(int(i) % v != end_id for i in want[:valid]))
        out.append(rec)
    return out


def _split_pairs(k2, plain, arbiter, t, n, got, want, valid, v):
    """The pairs of one split (explain_splits) and the image's largest f32
    errors against f64 over its live candidates at that step."""
    ck = k2["cands"][t][n].double()
    cp = plain["cands"][t][n].double()
    ca = arbiter["cands"][t][n]
    pairs, seen = [], set()
    for rank in range(valid):
        a, b = int(got[rank]), int(want[rank])
        if a == b or frozenset((a, b)) in seen:
            continue
        seen.add(frozenset((a, b)))
        sk, sp, sa = ([float(c[i]) for i in (a, b)] for c in (ck, cp, ca))
        gap = abs(sa[0] - sa[1])
        err_k2 = abs(sk[0] - sa[0]) + abs(sk[1] - sa[1])
        err_plain = abs(sp[0] - sa[0]) + abs(sp[1] - sa[1])
        pairs.append(dict(
            rank=rank, k2=[a // v, a % v], plain=[b // v, b % v],
            k2_scores=sk, plain_scores=sp, f64_scores=sa, gap_f64=gap,
            err_k2=err_k2, err_plain=err_plain,
            f32_ulp=float(np.spacing(np.float32(abs(sa[0])))),
            f64_prefers=("k2" if sa[0] > sa[1] else
                         "plain" if sa[1] > sa[0] else "tie"),
            explained=gap <= err_k2 + err_plain))
    live = ca > -1e8
    return dict(step=t, pairs=pairs,
                image_err_k2=float((ck - ca)[live].abs().max()),
                image_err_plain=float((cp - ca)[live].abs().max()))


def trace_k2_splits(ops, k, start_id, end_id, images, steps):
    """K2's splits from its f32 plain version on ``images``, traced over
    the first ``steps`` steps against the float64 arbiter
    (``explain_splits``; ``k2_step_record`` launches K2 ``steps`` + 1
    times). Returns (the splits, K2's record's ``prefix_equal``)."""
    images = list(images)
    if not images:
        return [], True
    plain = plain_step_record(ops, k, start_id, end_id, steps, images)
    steps = len(plain["choices"])
    arbiter = plain_step_record(ops, k, start_id, end_id, steps, images,
                                acc=torch.float64, replay=plain["choices"])
    k2 = k2_step_record(ops, k, start_id, end_id, steps, images)
    v = ops["emb"].shape[0]
    return (explain_splits(k2, plain, arbiter, images, k, v, end_id),
            k2["prefix_equal"])
