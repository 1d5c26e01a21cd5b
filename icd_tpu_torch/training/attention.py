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

The encoder is frozen on this path (its parameters carry
``requires_grad=False`` and its forward runs under ``torch.no_grad()``);
its train-mode BN statistics are written back after each step. The
decoder trains with Adam over value-clipped gradients, its embedding
table frozen unless ``--fine_tune_embedding``. No kernel of
``ops/`` runs here: the teacher-forced forward is plain PyTorch under
autograd, as the JAX scan is plain XLA.
"""

import os
import time

import numpy as np
import torch

from ..checkpoint import load_checkpoint, save_checkpoint, unpack_checkpoint
from ..data.dataset import COCODataset
from ..data.pipeline import (DataLoader, eval_workers, host_prefetch,
                             to_device)
from ..device import resolve_device, use_exact_f32
from ..metric import AccumulatingMetric, get_eval_score, probe_meteor
from ..models.attention import (AttentionDecoderParams,
                                attention_decoder_forward,
                                init_attention_decoder,
                                load_pretrained_embeddings)
from ..models.encoder import (encoder_attention_forward,
                              init_encoder_attention, trainable_mask)
from ..models.resnet import merge_bn_stats
from ..params import (adam_state_from_jax, adam_state_to_jax,
                      decoder_from_jax, decoder_to_jax, encoder_from_jax,
                      encoder_to_jax)
from ..pathconf import _root
from ..vocabulary import END_TOKEN, PAD_TOKEN, START_TOKEN
from .common import (LossDrain, clip_gradients, cross_entropy,
                     doubly_stochastic_regularizer, make_optimizer,
                     token_nll)


def not_ported(what, item):
    """The error for an option the port does not have yet, naming its
    item in ROADMAP.md's Queue 1."""
    return NotImplementedError(
        "{} is not ported to icd_tpu_torch yet (ROADMAP.md, Queue 1: "
        "{})".format(what, item))


def check_ported(args):
    """Raise for the train flags the port does not run yet, rather than
    silently training something else."""
    if getattr(args, "use_bert", False):
        raise not_ported("--use_bert", "BERT")
    if getattr(args, "amp", False):
        raise not_ported("--amp", "AMP")
    if getattr(args, "int8_encoder", False):
        raise not_ported("--int8_encoder", "baseline training and "
                         "--int8_encoder")


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


def trainable_parameters(encoder, decoder, fine_tune_embedding=False):
    """Mark what trains and return (encoder params, decoder params).

    The attention encoder has no head and its backbone is frozen
    (attention.py:183-189); the decoder trains whole, its embedding
    table only with ``fine_tune_embedding``. The rest is set
    ``requires_grad=False``, so autograd never builds its backward.
    """
    mask = trainable_mask(encoder)
    enc = []
    for name, p in encoder.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            enc.append(p)
    dec = []
    for name, p in decoder.named_parameters():
        on = fine_tune_embedding or not name.startswith("embedding.")
        p.requires_grad_(on)
        if on:
            dec.append(p)
    return enc, dec


def decoder_loss(decoder, grid, captions, decode_lengths, alpha_c,
                 generator=None, dropout_rate=0.0):
    """The train loss of the teacher-forced decoder on ``grid``
    (attention.py:100-117), in f32: the CE over the decode window (a
    masked mean: pack_padded over the uniform decode lengths) plus
    ``alpha_c``'s doubly-stochastic term."""
    captions = captions.long()
    scores, alphas = attention_decoder_forward(
        decoder, grid, captions, decode_lengths, generator=generator,
        dropout_rate=dropout_rate)
    return (cross_entropy(scores, captions[:, 1:], decode_lengths)
            + doubly_stochastic_regularizer(alphas.float(), alpha_c))


def make_train_step(encoder, decoder, optimizer, alpha_c, dropout_rate,
                    grad_clip=None):
    """The train step for the attention model (attention.py:72).

    ``step(imgs, captions, decode_lengths, generator)`` runs the frozen
    encoder in train mode (its new BN statistics written back), the
    teacher-forced decoder with dropout from ``generator``, the loss
    (CE over the decode window plus ``alpha_c``'s doubly-stochastic
    term, in f32), the backward, clipping and the Adam step. It returns
    the loss as a 0-d tensor on the device, not synchronised.
    """

    def step(imgs, captions, decode_lengths, generator=None):
        with torch.no_grad():
            grid, new_stats = encoder_attention_forward(encoder, imgs,
                                                        train=True)
        loss = decoder_loss(decoder, grid, captions, decode_lengths,
                            alpha_c, generator, dropout_rate)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_gradients(optimizer, grad_clip)
        optimizer.step()
        merge_bn_stats(new_stats)
        return loss.detach()

    return step


def train_epoch(step, batches, device, generator=None, epoch=0, epochs=1,
                num_batches=None, print_freq=1):
    """One epoch of ``step`` over ``batches`` (attention.py:243-310).

    ``batches`` is any iterable of dicts holding numpy ``imgs``
    (B, H, W, 3) uint8, ``captions`` (B, T) and ``padded_lengths`` (B,):
    the ``DataLoader``'s batches, or batches made in memory. Images go to
    the card from pinned memory without blocking the host. Losses are
    fetched 16 at a time (``LossDrain``) and printed as the JAX driver
    prints them. Returns the per-batch losses.
    """
    if num_batches is None:
        num_batches = len(batches)
    batch_losses = []
    accum_loss = AccumulatingMetric()
    accum_time = AccumulatingMetric()

    def finish(loss_val, batch_idx, dt):
        batch_losses.append(loss_val)
        accum_loss.update(loss_val)
        accum_time.update(dt)
        if batch_idx % print_freq == 0:
            print("Epoch {}/{}, Batch {}/{}, Loss {:.4f}, Time: {:.4f}".format(
                epoch + 1, epochs, batch_idx + 1, num_batches,
                accum_loss.avg(), accum_time.val))

    drain = LossDrain(finish)
    for batch_idx, batch in enumerate(batches):
        # Reference quirk: lengths measured after padding -> a uniform
        # decode window covering pads (attention.py:311-313).
        decode_lengths = np.asarray(batch["padded_lengths"]) - 1
        loss = step(to_device(batch["imgs"], device),
                    to_device(batch["captions"], device),
                    to_device(decode_lengths, device), generator)
        drain.push(loss, batch_idx)
    drain.flush()
    return batch_losses


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

    if args.checkpoint is None:
        encoder, decoder = build_attention(
            args, vocab, torch.Generator().manual_seed(0), device)
        start_epoch, metrics, opt_state = 0, {}, None
    else:
        (start_epoch, enc_tree, dec_tree, _enc_opt, opt_state,
         metrics) = unpack_checkpoint(load_checkpoint(args))
        encoder = encoder_from_jax(enc_tree).to(device)
        decoder = decoder_from_jax(dec_tree).to(device)
        start_epoch += 1

    enc_params, dec_params = trainable_parameters(
        encoder, decoder, args.fine_tune_embedding)
    optimizer = make_optimizer(enc_params, dec_params, args.encoder_lr,
                               args.decoder_lr)
    if opt_state is not None:
        optimizer.state.update(adam_state_from_jax(opt_state, decoder))
    step = make_train_step(encoder, decoder, optimizer, args.alpha_c,
                           args.decoder_dropout, args.grad_clip)
    generator = torch.Generator(device).manual_seed(1)

    epoch_losses = metrics.get("epoch_losses", [])
    for epoch in range(start_epoch, args.epochs):
        batch_losses = train_epoch(
            step, host_prefetch(iter(loader), size=2), device, generator,
            epoch, args.epochs, len(loader), args.print_freq)
        epoch_losses.append(batch_losses)
        metrics = {"epoch_losses": epoch_losses}
        save_checkpoint(args, epoch, encoder_to_jax(encoder),
                        decoder_to_jax(decoder), None,
                        adam_state_to_jax(optimizer, decoder), metrics)

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

    def staged():
        # Producer thread: ship the inputs while the card computes the
        # previous batch. Batch-1 semantics: each sample's decode length
        # is its own caption length - 1.
        for batch in iter(loader):
            yield (to_device(batch["imgs"], device),
                   to_device(batch["captions"], device),
                   to_device(batch["caption_lengths"] - 1, device), batch)

    def drain(pending, batch_idx):
        per_sample, preds, batch = pending
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

    pending = None
    for batch_idx, (imgs, captions, dec_lens, batch) in enumerate(
            host_prefetch(staged(), size=2)):
        per_sample, preds = step(imgs, captions, dec_lens)
        if pending is not None:
            drain(*pending)
        pending = ((per_sample, preds, batch), batch_idx)
    if pending is not None:
        drain(*pending)

    metrics = get_eval_score(references, hypotheses)
    metrics["losses"] = losses
    print("Checkpoint {} finished evaluation in {:.4f} seconds.".format(
        getattr(args, "checkpoint", None), time.time() - start_time))
    return metrics
