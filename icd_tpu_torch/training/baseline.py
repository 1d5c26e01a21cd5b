"""Baseline LSTM captioner: train / evaluate drivers (port of
``icd_tpu/training/baseline.py``; reference: models/baseline.py:114-374).

Faithfully reproduced quirks, as in the JAX package:
 - the loss targets are the full caption, <start> at t = 0 included,
   under ignore_index=<pad>: logits[:, t] predicts captions[:, t]
   (baseline.py:224-225, 194-195)
 - the frozen trunk runs its BN in train mode during training
   (baseline.py:197-198) and in eval mode in evaluate
 - the encoder's ``embed`` head takes Adam steps only with
   --fine_tune_encoder (baseline.py:158-163: without it the reference
   has no encoder optimizer, so the head stays at its init)
 - the eval CE has no ignore_index: each sample's mean NLL over its own
   caption_lengths positions, <start> and <end> included (batch-1
   CrossEntropyLoss, baseline.py:304-341)
 - eval references repeat the cleaned caption once per original token
   position (baseline.py:345-350); the attention model repeats it once
   per target position

icd_tpu's baseline loader pads captions to a multiple of 8
(``icd_tpu/data/pipeline.py:80-85``), the port's to the batch's
longest: under the pad mask the loss and its gradients are the same, up
to the order of the sums, and the eval losses and predictions are cut
to each caption's length.

--amp runs the trunk and the decoder in bf16 over f32 masters (the head
stays f32); --int8_encoder takes the features from the static-int8
trunk, whose BN statistics then stay as ``prepare_int8_encoder`` warmed
them (``training/common.py``). No kernel of ``ops/`` runs here: the
JAX train and eval steps are plain XLA.
"""

import time

import torch

from ..data.dataset import COCODataset
from ..data.pipeline import DataLoader, eval_workers
from ..device import resolve_device, use_exact_f32
from ..metric import AccumulatingMetric, get_eval_score, probe_meteor
from ..models.baseline import (BaselineDecoderParams,
                               baseline_decoder_forward,
                               init_baseline_decoder,
                               load_pretrained_embeddings)
from ..models.encoder import (encoder_forward, encoder_forward_int8,
                              init_encoder)
from ..models.resnet import merge_bn_stats
from ..parallel.mesh import batch_layout
from ..params import decoder_from_jax, encoder_from_jax
from ..utils.profiling import annotate
from ..vocabulary import END_TOKEN, PAD_TOKEN, START_TOKEN
from .common import (as_device_tensor, cast_floating, clip_gradients,
                     eval_batches, is_lead, make_adam, pad_cross_entropy,
                     pretrained_resnet_or_none, reduce_gradients,
                     resume_or_build, step_batch, token_nll, train_epochs,
                     train_precision)


def build_baseline(args, vocab, generator, device=None):
    """Random-init encoder (ResNet-101 and the ``embed`` head) and decoder
    from ``generator`` (CPU) per the CLI's args (baseline.py:75); a
    ``models/resnet101.pth`` under ``ICD_TPU_ROOT`` replaces the random
    backbone (``pretrained_resnet_or_none``)."""
    params = BaselineDecoderParams()
    params.embed_size = args.embed_size
    params.hidden_size = args.decoder_dim
    params.vocab_size = len(vocab)

    encoder = init_encoder(generator, args.embed_size, device=device)
    pretrained = pretrained_resnet_or_none(device)
    if pretrained is not None:
        encoder.resnet = pretrained
    decoder = init_baseline_decoder(generator, params, device=device)
    if args.use_glove:
        from ..data.embed import load_glove_vectors

        decoder = load_pretrained_embeddings(decoder, load_glove_vectors())
    return encoder, decoder


def decoder_loss(decoder, feats, captions, pad_idx, compute_dtype=None,
                 group=None):
    """The train loss (baseline.py:113-130): the CE of the teacher-forced
    logits against the full caption, pads ignored, in f32. With
    ``compute_dtype`` the decoder runs on copies of its parameters in
    that dtype, on the features cast to it (``cast_floating``). Over a
    data ``group`` it is the rank's share of the global loss."""
    captions = captions.long()
    if compute_dtype is not None:
        feats = feats.to(compute_dtype)
    scores = cast_floating(baseline_decoder_forward, decoder, compute_dtype,
                           feats, captions)
    return pad_cross_entropy(scores, captions, pad_idx, group)


def make_train_step(encoder, decoder, optimizer, pad_idx, grad_clip=None,
                    compute_dtype=None, qresnet=None, mesh=None):
    """The train step for the baseline model (baseline.py:95-145).

    ``step(imgs, captions)`` runs the frozen trunk in train mode (its new
    BN statistics written back) and the head, the teacher-forced
    decoder, the loss, the backward, clipping and the Adam step, and
    returns the loss as a 0-d tensor on the device, not synchronised.
    The trunk's parameters take no gradients, so autograd records only
    the head (when it trains) and the decoder.

    ``compute_dtype`` (bf16 with --amp) runs the trunk and the decoder in
    that dtype over f32 masters; the head computes in f32. ``qresnet``
    (--int8_encoder) takes the features from the int8 trunk at
    ``compute_dtype`` (f32 when None); BN statistics then do not update.

    On a ``mesh`` the step takes this rank's rows of a global batch of
    ``batch_size`` and runs the JAX step's global semantics, as the
    attention model's ``make_train_step`` says, and it has that step's
    spans (``train_trunk`` holds the head).
    """

    def step(imgs, captions, batch_size=None):
        _, group = batch_layout(
            mesh, imgs.shape[0] if batch_size is None else batch_size)
        new_stats = None
        with annotate("train_trunk"):
            if qresnet is None:
                feats, new_stats = encoder_forward(
                    encoder, imgs, compute_dtype=compute_dtype, train=True,
                    group=group)
            else:
                feats = encoder_forward_int8(encoder, qresnet, imgs,
                                             compute_dtype or torch.float32)
        with annotate("train_decoder"):
            loss = decoder_loss(decoder, feats, captions, pad_idx,
                                compute_dtype, group)
        with annotate("train_backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = reduce_gradients(optimizer, loss, group)
        with annotate("train_clip"):
            clip_gradients(optimizer, grad_clip)
        with annotate("train_adam"):
            optimizer.step()
        if new_stats is not None:
            with annotate("train_bn"):
                merge_bn_stats(new_stats)
        return loss

    return step


def batch_step(step, device, mesh=None):
    """``step`` as ``common.train_epoch`` calls it, on a loader batch or
    a staged one (``common.stage_batches``): this rank's rows of it (all
    of them without a ``mesh``) on ``device``."""
    def run(batch):
        batch, n = step_batch(batch, mesh)
        return step(as_device_tensor(batch["imgs"], device),
                    as_device_tensor(batch["captions"], device), n)
    return run


def train(args, device=None, mesh=None):
    """Train the baseline model (baseline.py:217; reference:
    models/baseline.py:114-264). Returns (encoder, decoder). On a
    data-parallel ``mesh``, as the attention model's ``train``."""
    device = resolve_device(device if mesh is None else mesh.device)
    use_exact_f32()
    dataset = COCODataset("train", caption_max_len=args.max_caption_length)
    vocab = dataset.vocab
    pad_idx = vocab(PAD_TOKEN)
    loader = DataLoader(
        dataset, batch_size=args.batch_size, shuffle=True,
        num_workers=args.workers, pad_idx=pad_idx)
    start_epoch, encoder, decoder, opt_state, metrics = resume_or_build(
        args, build_baseline, vocab, device)
    optimizer = make_adam(args, encoder, decoder, opt_state,
                          head=args.fine_tune_encoder, mesh=mesh)
    compute_dtype, qresnet = train_precision(args, encoder.resnet, loader,
                                             mesh)
    step = make_train_step(encoder, decoder, optimizer, pad_idx,
                           args.grad_clip, compute_dtype, qresnet, mesh)
    start = time.time()
    train_epochs(args, loader, batch_step(step, device, mesh), encoder,
                 decoder, optimizer, start_epoch, metrics, mesh=mesh,
                 device=device)
    if is_lead(mesh):
        print("Model {} finished training for {} epochs in {:.4f} seconds."
              .format(args.model_name, args.epochs, time.time() - start))
    return encoder, decoder


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def make_eval_step(encoder, decoder):
    """``step(imgs, captions, lengths)`` -> (per-sample loss (B,), argmax
    predictions (B, T)) (baseline.py:368): eval-mode BN; each sample's CE
    is its mean NLL over its own ``lengths`` positions, <start> and
    <end> included, with no ignore_index (batch-1 CrossEntropyLoss,
    baseline.py:304-341)."""

    @torch.no_grad()
    def step(imgs, captions, lengths):
        captions = captions.long()
        feats = encoder_forward(encoder, imgs)
        scores = baseline_decoder_forward(decoder, feats, captions).float()
        nll = token_nll(scores, captions, lengths)
        return nll.sum(1) / lengths.float(), scores.argmax(2)

    return step


def scoring_texts(preds, captions, caption_lengths, special):
    """(references, hypotheses) of a batch for ``get_eval_score``
    (baseline.py:466-478): each sample's caption up to its length without
    the special ids, repeated once per token position of the caption;
    the hypothesis is its argmax predictions cut to the same length, then
    stripped of the special ids."""
    references, hypotheses = [], []
    for pred, caption, length in zip(preds, captions, caption_lengths):
        cap = caption[:int(length)]
        references.append([[int(w) for w in cap if int(w) not in special]]
                          * len(cap))
        hypotheses.append([int(w) for w in pred[:int(length)]
                           if int(w) not in special])
    return references, hypotheses


def evaluate(args, encoder, decoder, batch_size=64, device=None):
    """Teacher-forced eval of the val split (baseline.py:401; reference:
    models/baseline.py:267-374) from the checkpoint's numpy trees
    ``encoder`` and ``decoder``. The last batch runs at its own size and
    captions are padded to the batch's longest (losses and predictions
    are cut to each caption's length). Returns the metric dict with the
    per-sample ``losses``."""
    device = resolve_device(device)
    use_exact_f32()
    # Fail fast on a missing METEOR runtime, before the decode loop.
    probe_meteor()
    dataset = COCODataset("val", caption_max_len=args.max_caption_length)
    vocab = dataset.vocab
    special = {vocab(START_TOKEN), vocab(END_TOKEN), vocab(PAD_TOKEN)}
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
        for loss_val in per_sample.tolist():
            losses.append(loss_val)
            accum_loss.update(loss_val)
        refs, hyps = scoring_texts(preds.cpu().numpy(), batch["captions"],
                                   batch["caption_lengths"], special)
        references.extend(refs)
        hypotheses.extend(hyps)
        if batch_idx % args.print_freq == 0:
            print("Batch {}/{}, Loss {:.4f}".format(
                batch_idx + 1, num_batches, accum_loss.avg()))

    eval_batches(loader, step, device, drain)
    metrics = get_eval_score(references, hypotheses)
    metrics["losses"] = losses
    print("Checkpoint {} finished evaluation in {:.4f} seconds.".format(
        getattr(args, "checkpoint", None), time.time() - start_time))
    return metrics
