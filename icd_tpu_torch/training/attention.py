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

With ``--use_bert`` the decoder reads BERT's caption embeddings
(``models/bert_embed.py``) instead of its table, which stays frozen.
Both make them on the run's device (``ICD_TPU_BERT_INT8=1``: the W8A8
BERT in training): training on the thread that prepares the next batch,
from the padded rows; eval from each caption without its padding.
"""

import os
import time

import torch

from ..data.dataset import COCODataset
from ..data.pipeline import DataLoader, eval_workers
from ..device import resolve_device, use_exact_f32
from ..metric import AccumulatingMetric, get_eval_score, probe_meteor
from ..models.attention import (AttentionDecoderParams,
                                attention_decoder_forward,
                                init_attention_decoder,
                                load_pretrained_embeddings)
from ..models.bert_embed import BertCaptionEmbedder
from ..models.encoder import (encoder_attention_forward,
                              encoder_attention_forward_int8,
                              init_encoder_attention)
from ..models.resnet import merge_bn_stats
from ..parallel.mesh import batch_layout, shard_batch
from ..params import decoder_from_jax, encoder_from_jax
from ..vocabulary import END_TOKEN, PAD_TOKEN, START_TOKEN
from .common import (as_device_tensor, cast_floating, clip_gradients,
                     cross_entropy, doubly_stochastic_regularizer,
                     eval_batches, is_lead, make_adam,
                     pretrained_resnet_or_none, reduce_gradients,
                     resume_or_build, step_batch, token_nll, train_epochs,
                     train_precision)


def build_attention(args, vocab, generator, device=None):
    """Random-init encoder and decoder from ``generator`` (CPU) per the
    CLI's args (attention.py:50); a ``models/resnet101.pth`` under
    ``ICD_TPU_ROOT`` replaces the random backbone
    (``pretrained_resnet_or_none``)."""
    params = AttentionDecoderParams()
    params.attention_dim = args.attention_dim
    params.decoder_dim = args.decoder_dim
    params.embed_size = args.embed_size
    params.dropout = args.decoder_dropout
    params.vocab = vocab
    params.use_bert = args.use_bert

    encoder = init_encoder_attention(generator, device=device)
    pretrained = pretrained_resnet_or_none(device)
    if pretrained is not None:
        encoder.resnet = pretrained
    decoder = init_attention_decoder(generator, params, device=device)
    if args.use_glove:
        from ..data.embed import load_glove_vectors

        decoder = load_pretrained_embeddings(decoder, load_glove_vectors())
    return encoder, decoder


def decoder_loss(decoder, grid, captions, decode_lengths, alpha_c,
                 generator=None, dropout_rate=0.0, compute_dtype=None,
                 embeddings=None, group=None, mask_rows=None):
    """The train loss of the teacher-forced decoder on ``grid``
    (attention.py:100-117), in f32: the CE over the decode window (a
    masked mean: pack_padded over the uniform decode lengths) plus
    ``alpha_c``'s doubly-stochastic term. With ``compute_dtype`` the
    decoder runs on copies of its parameters in that dtype, on the grid
    and the BERT ``embeddings`` cast to it (``cast_floating``,
    attention.py:104-105). Over a data ``group`` the rows are the rank's
    ``mask_rows`` = (rows, n) of a global batch of n and the loss is the
    rank's share of the global one."""
    captions = captions.long()
    if compute_dtype is not None:
        grid = grid.to(compute_dtype)
        if embeddings is not None:
            embeddings = embeddings.to(compute_dtype)
    scores, alphas = cast_floating(
        attention_decoder_forward, decoder, compute_dtype, grid, captions,
        decode_lengths, generator, dropout_rate, embeddings, mask_rows)
    return (cross_entropy(scores, captions[:, 1:], decode_lengths, group)
            + doubly_stochastic_regularizer(alphas.float(), alpha_c, group))


def make_train_step(encoder, decoder, optimizer, alpha_c, dropout_rate,
                    grad_clip=None, compute_dtype=None, qresnet=None,
                    mesh=None):
    """The train step for the attention model (attention.py:72).

    ``step(imgs, captions, decode_lengths, generator, embeddings)`` runs
    the frozen encoder in train mode (its new BN statistics written
    back), the teacher-forced decoder with dropout from ``generator``
    (on BERT's ``embeddings`` when given, else on its table), the loss
    (CE over the decode window plus ``alpha_c``'s doubly-stochastic
    term, in f32), the backward, clipping and the Adam step. It returns
    the loss as a 0-d tensor on the device, not synchronised.

    ``compute_dtype`` (bf16 with --amp) runs the trunk and the decoder in
    that dtype over f32 masters. ``qresnet`` (--int8_encoder) takes the
    grid from the int8 trunk at ``compute_dtype`` (f32 when None); BN
    statistics then do not update.

    On a ``mesh`` (``parallel/mesh.py``; the decoder already cut to its
    vocab shards by ``make_adam``) the step takes this rank's rows
    (``parallel.shard_batch``) of a global batch of ``batch_size`` and
    runs the JAX step's global semantics: BN statistics over the global
    batch, the dropout mask of the global batch, the loss over global
    counts, the gradients summed over the data ranks before clipping,
    and the global loss returned. A batch that does not divide over the
    data ranks comes whole to every rank and is not summed (batch_layout).
    """

    def step(imgs, captions, decode_lengths, generator=None, embeddings=None,
             batch_size=None):
        n = imgs.shape[0] if batch_size is None else batch_size
        rows, group = batch_layout(mesh, n)
        new_stats = None
        with torch.no_grad():
            if qresnet is None:
                grid, new_stats = encoder_attention_forward(
                    encoder, imgs, compute_dtype=compute_dtype, train=True,
                    group=group)
            else:
                grid = encoder_attention_forward_int8(
                    qresnet, imgs, compute_dtype or torch.float32)
        loss = decoder_loss(decoder, grid, captions, decode_lengths,
                            alpha_c, generator, dropout_rate, compute_dtype,
                            embeddings, group,
                            None if mesh is None else (rows, n))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_gradients(optimizer, loss, group)
        clip_gradients(optimizer, grad_clip)
        optimizer.step()
        if new_stats is not None:
            merge_bn_stats(new_stats)
        return loss

    return step


def batch_step(step, device, generator=None, mesh=None):
    """``step`` as ``common.train_epoch`` calls it, on a loader batch or
    a staged one (``common.stage_batches``): this rank's rows of it (all
    of them without a ``mesh``) on ``device``, and the decode lengths
    the padded length - 1 (reference quirk: lengths measured after
    padding, a uniform decode window covering pads,
    attention.py:311-313). A batch's ``embeddings`` (``--use_bert``,
    already the rank's rows: ``with_bert``) go along."""
    def run(batch):
        batch, n = step_batch(batch, mesh)
        embeddings = batch.get("embeddings")
        if embeddings is not None:
            embeddings = as_device_tensor(embeddings, device)
        return step(as_device_tensor(batch["imgs"], device),
                    as_device_tensor(batch["captions"], device),
                    as_device_tensor(batch["padded_lengths"] - 1, device),
                    generator, embeddings, n)
    return run


def with_bert(embedder, mesh=None):
    """``train_epochs``' ``prepare``: each batch gets its captions' BERT
    embeddings, of the padded rows as the reference trains
    (attention.py:242-247); on a ``mesh``, of this rank's rows only."""
    def prepare(batch):
        captions = batch["captions"]
        if mesh is not None:
            captions = shard_batch(captions, mesh)
        batch["embeddings"] = embedder(captions)
        return batch
    return prepare


def train(args, device=None, mesh=None):
    """Train the attention model (attention.py:133; reference:
    models/attention.py:287-452). Returns (encoder, decoder).

    On a data-parallel ``mesh`` (``icd_tpu_torch.train`` under
    ``torchrun``) each rank runs on ``mesh.device``: its loader has the
    same seed and order, and its steps take their rows of each batch;
    global rank 0 prints and writes the checkpoints."""
    device = resolve_device(device if mesh is None else mesh.device)
    use_exact_f32()
    dataset = COCODataset("train", caption_max_len=args.max_caption_length)
    vocab = dataset.vocab
    loader = DataLoader(
        dataset, batch_size=args.batch_size, shuffle=True,
        num_workers=args.workers, pad_idx=vocab(PAD_TOKEN))
    start_epoch, encoder, decoder, opt_state, metrics = resume_or_build(
        args, build_attention, vocab, device)
    optimizer = make_adam(args, encoder, decoder, opt_state, mesh=mesh)
    compute_dtype, qresnet = train_precision(args, encoder.resnet, loader,
                                             mesh)
    step = make_train_step(encoder, decoder, optimizer, args.alpha_c,
                           args.decoder_dropout, args.grad_clip,
                           compute_dtype, qresnet, mesh)
    prepare = None
    if args.use_bert:
        prepare = with_bert(BertCaptionEmbedder(
            vocab, device=device,
            int8=bool(os.environ.get("ICD_TPU_BERT_INT8"))), mesh)
    generator = torch.Generator(device).manual_seed(1)
    train_epochs(args, loader, batch_step(step, device, generator, mesh),
                 encoder, decoder, optimizer, start_epoch, metrics, prepare,
                 mesh, device)
    if is_lead(mesh):
        print("Model {} finished training for {} epochs.".format(
            args.model_name, args.epochs))
    return encoder, decoder


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def make_eval_step(encoder, decoder):
    """``step(imgs, captions, decode_lengths, embeddings=None)`` ->
    (per-sample loss (B,), argmax predictions (B, T - 1))
    (attention.py:330): eval-mode BN, no dropout, BERT's ``embeddings``
    when given; the per-sample CE over the sample's own decode length
    plus the regularizer with alpha_c = 1 (attention.py:529-531)."""

    @torch.no_grad()
    def step(imgs, captions, decode_lengths, embeddings=None):
        captions = captions.long()
        grid = encoder_attention_forward(encoder, imgs)
        scores, alphas = attention_decoder_forward(
            decoder, grid, captions, decode_lengths, embeddings=embeddings)
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
    per-sample ``losses``.

    ``use_bert`` teacher-forces with BERT's embeddings of each caption
    without its padding (the reference's batch-1 texts), made on
    ``device`` (attention.py:388-400, 430-440)."""
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
    embed = None
    if use_bert:
        embedder = BertCaptionEmbedder(vocab, device=device)

        def embed(batch):
            return embedder(batch["captions"],
                            lengths=batch["caption_lengths"])

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

    eval_batches(loader, step, device, drain, length_offset=1, embed=embed)
    metrics = get_eval_score(references, hypotheses)
    metrics["losses"] = losses
    print("Checkpoint {} finished evaluation in {:.4f} seconds.".format(
        getattr(args, "checkpoint", None), time.time() - start_time))
    return metrics
