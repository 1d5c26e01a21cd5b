"""Attention captioner: train / evaluate drivers (port of
``icd_tpu/training/attention.py``; reference: models/attention.py:287-567).

Faithfully reproduced quirks, as in the JAX package:
 - caption_lengths are computed after padding, so decode lengths are
   uniform per batch (attention.py:311-313) and the train CE (no
   ignore_index) averages over every position of the decode window,
   pads included (attention.py:399-411)
 - the doubly-stochastic attention regularizer is added with
   args.alpha_c in train (attention.py:413-414) and alpha_c=1 in eval
   (attention.py:529-531)
 - eval hypotheses truncate to decode_length before stripping special
   tokens (attention.py:543-553); references are built from targets
   (captions[1:]) duplicated per target position (attention.py:535-541)

The encoder is frozen on this path: its train-mode BN statistics are
written back after each step, except over the int8 trunk of
``--int8_encoder``, whose statistics stay as ``prepare_int8_encoder``
warmed them. The decoder trains with Adam over value-clipped gradients,
its embedding table frozen unless ``--fine_tune_embedding``; under
``--amp`` it computes in bf16 on bf16 copies of its f32 parameters, and
its scores are rounded to bf16 before the softmax as JAX's
``soft_attention`` rounds them. No kernel of ``ops/`` runs here: the
teacher-forced forward is plain PyTorch under autograd, as the JAX scan
is plain XLA.
"""

import os
import time

import numpy as np
import torch

from ..data.dataset import COCODataset
from ..data.pipeline import DataLoader, eval_workers, to_device
from ..device import resolve_device, use_exact_f32
from ..metric import AccumulatingMetric, get_eval_score, probe_meteor
from ..models.attention import (AttentionDecoderParams,
                                attention_decoder_forward,
                                init_attention_decoder,
                                load_pretrained_embeddings)
from ..models.encoder import (encoder_attention_forward,
                              encoder_attention_forward_int8,
                              init_encoder_attention)
from ..models.resnet import merge_bn_stats
from ..params import decoder_from_jax, encoder_from_jax
from ..pathconf import _root
from ..vocabulary import END_TOKEN, PAD_TOKEN, START_TOKEN
from .common import (cast_floating, check_ported, clip_gradients,
                     cross_entropy, doubly_stochastic_regularizer,
                     eval_batches, make_adam, not_ported, resume_or_build,
                     token_nll, train_epochs, train_precision)


def build_attention(args, vocab, generator, device=None):
    """Random-init encoder and decoder from ``generator`` (CPU) per the
    CLI's args (attention.py:50)."""
    params = AttentionDecoderParams()
    params.attention_dim = args.attention_dim
    params.decoder_dim = args.decoder_dim
    params.embed_size = args.embed_size
    params.dropout = args.decoder_dropout
    params.vocab = vocab
    params.use_bert = args.use_bert

    if os.path.exists(os.path.join(_root(), "models", "resnet101.pth")):
        # icd_tpu would load it (training/baseline.py:59-72).
        raise not_ported("loading models/resnet101.pth",
                         ".pth.tar and .pth conversion")
    encoder = init_encoder_attention(generator, device=device)
    decoder = init_attention_decoder(generator, params, device=device)
    if args.use_glove:
        from ..data.embed import load_glove_vectors

        decoder = load_pretrained_embeddings(decoder, load_glove_vectors())
    return encoder, decoder


def decoder_loss(decoder, grid, captions, decode_lengths, alpha_c,
                 generator=None, dropout_rate=0.0, compute_dtype=None):
    """The train loss of the teacher-forced decoder on ``grid``
    (attention.py:100-117), in f32: the CE over the decode window (a
    masked mean: pack_padded over the uniform decode lengths) plus
    ``alpha_c``'s doubly-stochastic term. With ``compute_dtype`` the
    decoder runs on copies of its parameters in that dtype, on the grid
    cast to it (``cast_floating``)."""
    captions = captions.long()
    if compute_dtype is not None:
        grid = grid.to(compute_dtype)
    scores, alphas = cast_floating(
        attention_decoder_forward, decoder, compute_dtype, grid, captions,
        decode_lengths, generator, dropout_rate)
    return (cross_entropy(scores, captions[:, 1:], decode_lengths)
            + doubly_stochastic_regularizer(alphas.float(), alpha_c))


def make_train_step(encoder, decoder, optimizer, alpha_c, dropout_rate,
                    grad_clip=None, compute_dtype=None, qresnet=None):
    """The train step for the attention model (attention.py:72).

    ``step(imgs, captions, decode_lengths, generator)`` runs the frozen
    encoder in train mode (its new BN statistics written back), the
    teacher-forced decoder with dropout from ``generator``, the loss
    (CE over the decode window plus ``alpha_c``'s doubly-stochastic
    term, in f32), the backward, clipping and the Adam step. It returns
    the loss as a 0-d tensor on the device, not synchronised.

    ``compute_dtype`` (bf16 with --amp) runs the trunk and the decoder in
    that dtype over f32 masters. ``qresnet`` (--int8_encoder) takes the
    grid from the int8 trunk at ``compute_dtype`` (f32 when None); BN
    statistics then do not update.
    """

    def step(imgs, captions, decode_lengths, generator=None):
        new_stats = None
        with torch.no_grad():
            if qresnet is None:
                grid, new_stats = encoder_attention_forward(
                    encoder, imgs, compute_dtype=compute_dtype, train=True)
            else:
                grid = encoder_attention_forward_int8(
                    qresnet, imgs, compute_dtype or torch.float32)
        loss = decoder_loss(decoder, grid, captions, decode_lengths,
                            alpha_c, generator, dropout_rate, compute_dtype)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_gradients(optimizer, grad_clip)
        optimizer.step()
        if new_stats is not None:
            merge_bn_stats(new_stats)
        return loss.detach()

    return step


def batch_step(step, device, generator=None):
    """``step`` as ``common.train_epoch`` calls it, on a loader batch:
    the arrays go to ``device``, and the decode lengths are the padded
    length - 1 (reference quirk: lengths measured after padding, a
    uniform decode window covering pads, attention.py:311-313)."""
    def run(batch):
        decode_lengths = np.asarray(batch["padded_lengths"]) - 1
        return step(to_device(batch["imgs"], device),
                    to_device(batch["captions"], device),
                    to_device(decode_lengths, device), generator)
    return run


def train(args, device=None):
    """Train the attention model (attention.py:133; reference:
    models/attention.py:287-452). Returns (encoder, decoder)."""
    device = resolve_device(device)
    use_exact_f32()
    check_ported(args)
    dataset = COCODataset("train", caption_max_len=args.max_caption_length)
    vocab = dataset.vocab
    loader = DataLoader(
        dataset, batch_size=args.batch_size, shuffle=True,
        num_workers=args.workers, pad_idx=vocab(PAD_TOKEN))
    start_epoch, encoder, decoder, opt_state, metrics = resume_or_build(
        args, build_attention, vocab, device)
    optimizer = make_adam(args, encoder, decoder, opt_state)
    compute_dtype, qresnet = train_precision(args, encoder.resnet, loader)
    step = make_train_step(encoder, decoder, optimizer, args.alpha_c,
                           args.decoder_dropout, args.grad_clip,
                           compute_dtype, qresnet)
    generator = torch.Generator(device).manual_seed(1)
    train_epochs(args, loader, batch_step(step, device, generator), encoder,
                 decoder, optimizer, start_epoch, metrics)
    print("Model {} finished training for {} epochs.".format(
        args.model_name, args.epochs))
    return encoder, decoder


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def make_eval_step(encoder, decoder):
    """``step(imgs, captions, decode_lengths)`` -> (per-sample loss (B,),
    argmax predictions (B, T - 1)) (attention.py:330): eval-mode BN, no
    dropout; the per-sample CE over the sample's own decode length plus
    the regularizer with alpha_c = 1 (attention.py:529-531)."""

    @torch.no_grad()
    def step(imgs, captions, decode_lengths):
        captions = captions.long()
        grid = encoder_attention_forward(encoder, imgs)
        scores, alphas = attention_decoder_forward(decoder, grid, captions,
                                                   decode_lengths)
        scores = scores.float()
        nll = token_nll(scores, captions[:, 1:], decode_lengths)
        ce = nll.sum(1) / decode_lengths.float().clamp(min=1.0)
        reg = ((1.0 - alphas.float().sum(1)) ** 2).mean(-1)
        return ce + reg, scores.argmax(2)

    return step


def scoring_texts(preds, captions, caption_lengths, special):
    """(references, hypotheses) of a batch for ``get_eval_score``
    (attention.py:460-471): each sample's targets (captions[1:]) up to
    its decode length without the special ids, repeated once per target
    position; the hypothesis is its argmax predictions truncated to the
    decode length, then stripped of the special ids."""
    references, hypotheses = [], []
    for pred, caption, length in zip(preds, captions, caption_lengths):
        decode_len = int(length) - 1
        target = caption[1: 1 + decode_len]
        cleaned = [int(w) for w in target if int(w) not in special]
        references.append([cleaned] * len(target))
        hypotheses.append([int(w) for w in pred[:decode_len]
                           if int(w) not in special])
    return references, hypotheses


def evaluate(args, encoder, decoder, batch_size=64, use_bert=False,
             device=None):
    """Teacher-forced eval of the val split (attention.py:368;
    reference: models/attention.py:454-567) from the checkpoint's numpy
    trees ``encoder`` and ``decoder``. Returns the metric dict with the
    per-sample ``losses``."""
    if use_bert:
        raise not_ported("BERT teacher forcing", "BERT")
    device = resolve_device(device)
    use_exact_f32()
    # Fail fast on a missing METEOR runtime, before the decode loop.
    probe_meteor()
    dataset = COCODataset("val", caption_max_len=args.max_caption_length)
    vocab = dataset.vocab
    special = {vocab(START_TOKEN), vocab(END_TOKEN), vocab(PAD_TOKEN)}

    # The last batch runs at its own size and the captions are padded to
    # the batch's longest: the losses are per sample and masked, and the
    # predictions are cut to each decode length, so padding would only
    # add decode steps and rows (XLA pads them to keep its shapes static;
    # eager PyTorch has none).
    loader = DataLoader(
        dataset, batch_size=batch_size, shuffle=True,
        num_workers=eval_workers(), pad_idx=vocab(PAD_TOKEN))
    step = make_eval_step(encoder_from_jax(encoder).to(device),
                          decoder_from_jax(decoder).to(device))

    references, hypotheses, losses = [], [], []
    accum_loss = AccumulatingMetric()
    num_batches = len(loader)
    start_time = time.time()
    print("Started validation...")

    def drain(per_sample, preds, batch, batch_idx):
        # Batch-1 semantics: each sample's decode length is its own
        # caption length - 1.
        lengths = batch["caption_lengths"]
        for loss_val, decode_len in zip(per_sample.tolist(), lengths - 1):
            losses.append(loss_val)
            accum_loss.update(loss_val, int(decode_len))
        refs, hyps = scoring_texts(preds.cpu().numpy(), batch["captions"],
                                   lengths, special)
        references.extend(refs)
        hypotheses.extend(hyps)
        # The reference prints the running loss every batch, besides the
        # print_freq line (attention.py:557).
        print("loss: {}".format(accum_loss.avg()))
        if batch_idx % args.print_freq == 0:
            print("Batch {}/{}, Loss {:.4f}".format(
                batch_idx + 1, num_batches, accum_loss.avg()))

    eval_batches(loader, step, device, drain, length_offset=1)
    metrics = get_eval_score(references, hypotheses)
    metrics["losses"] = losses
    print("Checkpoint {} finished evaluation in {:.4f} seconds.".format(
        getattr(args, "checkpoint", None), time.time() - start_time))
    return metrics
