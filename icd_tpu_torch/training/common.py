"""Shared training machinery: losses, the AMP cast, the optimizer, the
loss drain, the epoch loop, the teacher-forced eval loop and the int8
trunk of ``--int8_encoder`` (port of ``icd_tpu/training/common.py:31-182``
and ``icd_tpu/training/baseline.py:52, 156-214``), used by both model
families' drivers.

Numerical conventions follow the reference exactly:
 - cross-entropy = torch ``nn.CrossEntropyLoss``: the baseline trains
   with ``ignore_index=<pad>`` (models/baseline.py:194-195,
   ``pad_cross_entropy``); the attention driver takes the mean over the
   positions within each row's decode length, which are uniform, so it
   counts every position of the padded decode window
   (models/attention.py:399-411, ``cross_entropy``)
 - gradient clipping is elementwise value clamping to +/-grad_clip
   before the Adam step (train_utils.py:2-12)
 - Adam uses torch defaults (b1=0.9, b2=0.999, eps=1e-8). optax's
   ``adam`` and ``torch.optim.Adam`` compute the same update, eps added
   after the bias-corrected square root; the port runs torch's
   ``foreach`` implementation on both devices.

Frozen parameters carry ``requires_grad=False`` and a frozen module runs
under ``torch.no_grad()`` (or on inputs none of which takes gradients),
so autograd never builds its backward, as the JAX package's
``partition`` keeps XLA from building it.

AMP (``--amp``, compute dtype bf16): the trunk and the decoder compute
in bf16 on bf16 copies of their f32 parameters (``cast_floating``); the
loss, its log-softmax, the regulariser, the master weights, Adam's
moments and the BN statistics stay f32. ``torch.autocast`` is not used:
it keeps its own set of operations (the LSTM gates, the softmax, the
elementwise passes) in f32 where the JAX package computes in bf16.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint import load_checkpoint, save_checkpoint, unpack_checkpoint
from ..data.pipeline import host_prefetch, to_device
from ..metric import AccumulatingMetric
from ..models.encoder import trainable_mask
from ..models.resnet import merge_bn_stats, resnet_forward
from ..models.resnet_int8 import calibrate_act_maxes, quantize_resnet
from ..ops.image import normalize_imagenet
from ..params import (adam_state_from_jax, adam_state_to_jax,
                      decoder_from_jax, decoder_to_jax, encoder_from_jax,
                      encoder_to_jax)


def not_ported(what, item):
    """The error for an option the port does not have yet, naming its
    item in ROADMAP.md's Queue 1."""
    return NotImplementedError(
        "{} is not ported to icd_tpu_torch yet (ROADMAP.md, Queue 1: "
        "{})".format(what, item))


class LossDrain:
    """Blocked loss fetcher for the per-batch-loss train loops
    (common.py:31).

    The reference records (and prints) a loss for every batch
    (models/baseline.py:245-258). Fetching each scalar makes the host
    wait for the card every step; the drain keeps the per-batch loss
    values and print lines unchanged while fetching ``BLOCK`` losses
    with one synchronisation (``torch.stack(...).tolist()``).

    The per-batch "Time:" column is the dispatch-to-dispatch interval
    (host pacing). The wait of each block's fetch lands in the next
    batch's interval, so printed times oscillate around the true mean;
    the loss values are exact.
    """

    BLOCK = 16  # losses fetched per synchronisation

    def __init__(self, finish):
        self.finish = finish  # finish(loss_val, batch_idx, dt_seconds)
        self._pending = []  # [(device_loss, batch_idx, dispatch_t)]
        self._last_t = time.time()

    def push(self, device_loss, batch_idx):
        now = time.time()
        self._pending.append((device_loss, batch_idx, now - self._last_t))
        self._last_t = now
        if len(self._pending) >= self.BLOCK:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        vals = torch.stack([p[0] for p in self._pending]).tolist()
        for val, (_, batch_idx, dt) in zip(vals, self._pending):
            self.finish(float(val), batch_idx, dt)
        self._pending = []


def _nll(logits, targets):
    """-log softmax(logits)[target] per position, in f32."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    return -logprobs.gather(-1, targets[..., None].long())[..., 0]


def token_nll(logits, targets, decode_lengths):
    """-log softmax(logits)[target] per position (B, T), in f32, zero
    past each row's decode length."""
    nll = _nll(logits, targets)
    steps = torch.arange(targets.shape[1], device=targets.device)
    return torch.where(steps[None, :] < decode_lengths[:, None], nll, 0.0)


def cross_entropy(logits, targets, decode_lengths):
    """torch CrossEntropyLoss over the positions within each row's decode
    length (common.py:144): the mean of ``token_nll`` over them, as
    pack_padded over the decode lengths gives it (attention.py:100-117).
    """
    nll = token_nll(logits, targets, decode_lengths)
    return nll.sum() / decode_lengths.sum().clamp(min=1)


def pad_cross_entropy(logits, targets, pad_idx):
    """torch ``CrossEntropyLoss(ignore_index=pad_idx)`` (common.py:144), in
    f32: the mean of the NLL over the positions whose target is not
    ``pad_idx``, divided by max(count, 1). Padding a batch further with
    ``pad_idx`` changes neither the loss nor its gradients."""
    counted = targets != pad_idx
    return (torch.where(counted, _nll(logits, targets), 0.0).sum()
            / counted.sum().clamp(min=1))


def doubly_stochastic_regularizer(alphas, alpha_c):
    """((alpha_c - sum_t alpha)^2).mean() (reference: attention.py:413-414)."""
    return ((alpha_c - alphas.sum(dim=1)) ** 2).mean()


class _Bound(torch.nn.Module):
    """``fn(module, *args)`` as a module's forward, for ``functional_call``."""

    def __init__(self, fn, module):
        super().__init__()
        self.fn, self.module = fn, module

    def forward(self, *args):
        return self.fn(self.module, *args)


def cast_floating(fn, module, dtype, *args):
    """``fn(module, *args)`` on ``dtype`` copies of ``module``'s floating
    parameters (common.py:100, the AMP cast), or on the module as it is
    when ``dtype`` is None.

    The copies are made inside autograd, so the gradients reach the f32
    masters through the casts' backward (in f32) and Adam steps f32
    weights with f32 moments; the module itself is not changed (casting
    it in place would make Adam step bf16 weights).
    """
    if dtype is None:
        return fn(module, *args)
    cast = {"module." + name: p.to(dtype) if p.is_floating_point() else p
            for name, p in module.named_parameters()}
    return torch.func.functional_call(_Bound(fn, module), cast, args)


def make_optimizer(encoder_params, decoder_params, encoder_lr, decoder_lr):
    """Adam with torch's defaults over two parameter groups, the
    per-module rates of ``make_optimizer_for`` (baseline.py:156-163). A
    group may be empty: the encoder trains nothing unless the baseline's
    head trains (--fine_tune_encoder)."""
    return torch.optim.Adam(
        [{"params": list(encoder_params), "lr": encoder_lr},
         {"params": list(decoder_params), "lr": decoder_lr}],
        betas=(0.9, 0.999), eps=1e-8, foreach=True)


def clip_gradients(optimizer, grad_clip):
    """Clamp every gradient the optimizer will apply to +/-grad_clip
    (common.py:172; None: no clipping)."""
    if grad_clip is not None:
        torch.nn.utils.clip_grad_value_(
            [p for group in optimizer.param_groups for p in group["params"]],
            grad_clip)


def trainable_parameters(encoder, decoder, fine_tune_embedding=False,
                         head=False):
    """Mark what trains and return (encoder params, decoder params).

    The backbone is frozen (``trainable_mask``); the baseline's ``embed``
    head trains with ``head`` (the driver passes --fine_tune_encoder,
    baseline.py:247-252); the decoder trains whole, its embedding table
    only with ``fine_tune_embedding`` (baseline.py:52). The rest is set
    ``requires_grad=False``, so autograd never builds its backward.
    """
    mask = trainable_mask(encoder, head=head)
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


def resume_or_build(args, build, vocab, device):
    """The models a train driver starts from: ``build(args, vocab,
    generator, device)`` from a generator seeded 0, or ``args.checkpoint``
    (the port's or ``icd_tpu``'s) on ``device``. Returns (first epoch,
    encoder, decoder, the checkpoint's Adam state or None, metrics)."""
    if args.checkpoint is None:
        encoder, decoder = build(args, vocab, torch.Generator().manual_seed(0),
                                 device)
        return 0, encoder, decoder, None, {}
    (epoch, enc_tree, dec_tree, _enc_opt, opt_state,
     metrics) = unpack_checkpoint(load_checkpoint(args))
    return (epoch + 1, encoder_from_jax(enc_tree).to(device),
            decoder_from_jax(dec_tree).to(device), opt_state, metrics)


def make_adam(args, encoder, decoder, opt_state, head=False):
    """Adam over the trainable parameters (``trainable_parameters``) at
    the CLI's rates, its state loaded from a checkpoint's ``opt_state``
    when there is one (``params.adam_state_from_jax``), for the
    parameters this run trains. With ``--use_bert`` the decoder's table
    is frozen whatever ``--fine_tune_embedding`` says: BERT's embeddings
    replace it (attention.py:190-192)."""
    fine_tune_embedding = (args.fine_tune_embedding
                           and not getattr(args, "use_bert", False))
    enc_params, dec_params = trainable_parameters(
        encoder, decoder, fine_tune_embedding, head)
    optimizer = make_optimizer(enc_params, dec_params, args.encoder_lr,
                               args.decoder_lr)
    if opt_state is not None:
        trained = {id(p) for p in enc_params + dec_params}
        optimizer.state.update(
            (p, state) for p, state in adam_state_from_jax(
                opt_state, decoder, encoder).items() if id(p) in trained)
    return optimizer


INT8_BN_WARMUP_BATCHES = 16


def prepare_int8_encoder(resnet, loader, compute_dtype, warmup=True):
    """BN-adapt, then quantize the frozen backbone for --int8_encoder
    (baseline.py:166-214). Returns the int8 tree; ``resnet``'s running
    statistics are updated in place and reach the checkpoint, so eval's
    inference BN agrees with what the decoder trained against.

    The int8 trunk runs inference-mode BN (statistics folded into the
    dequant affine), so first ``INT8_BN_WARMUP_BATCHES`` batches of f32
    train-mode BN adapt the running statistics (no compute dtype, even
    under --amp, as there); then the activation ranges are calibrated on
    the last warm-up batch at ``compute_dtype`` (f32 when None). With
    ``warmup=False`` (a resumed run) the checkpoint's statistics are kept
    and one batch calibrates. The batches come from one ``iter(loader)``,
    which draws one shuffle permutation, as the JAX package's does, so
    the epochs after it see icd_tpu's batch order. During training the
    statistics do not update.
    """
    device = resnet.stem.conv.device
    imgs = None
    it = iter(loader)
    with torch.no_grad():
        for _ in range(INT8_BN_WARMUP_BATCHES if warmup else 1):
            batch = next(it, None)
            if batch is None:
                break
            imgs = to_device(batch["imgs"], device)
            if warmup:
                _, stats = resnet_forward(resnet, normalize_imagenet(imgs),
                                          train=True)
                merge_bn_stats(stats)
    if imgs is None:
        raise RuntimeError(
            "--int8_encoder needs at least one training batch to "
            "calibrate activation ranges, but the data loader yielded "
            "none (empty dataset or over-aggressive --max_caption_length "
            "filter).")
    return quantize_resnet(resnet, calibrate_act_maxes(
        resnet, imgs, compute_dtype or torch.float32))


def train_precision(args, resnet, loader):
    """(compute dtype, int8 trunk or None) of a train run: bf16 with
    --amp (else None: f32), and with --int8_encoder the trunk that
    ``prepare_int8_encoder`` makes (warmed up unless resuming)."""
    compute_dtype = torch.bfloat16 if getattr(args, "amp", False) else None
    qresnet = None
    if getattr(args, "int8_encoder", False):
        qresnet = prepare_int8_encoder(resnet, loader, compute_dtype,
                                       warmup=args.checkpoint is None)
    return compute_dtype, qresnet


def train_epoch(step, batches, epoch=0, epochs=1, num_batches=None,
                print_freq=1):
    """One epoch of ``step`` over ``batches`` (baseline.py:305-347,
    attention.py:243-310). ``step(batch)`` runs one train step on a
    batch, a dict of numpy arrays (the ``DataLoader``'s, or made in
    memory), and returns the loss on the device, not synchronised.
    Losses are fetched 16 at a time (``LossDrain``) and printed as the
    JAX drivers print them. Returns the per-batch losses.
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
        drain.push(step(batch), batch_idx)
    drain.flush()
    return batch_losses


def train_epochs(args, loader, step, encoder, decoder, optimizer,
                 start_epoch, metrics, prepare=None):
    """Epochs ``start_epoch`` to ``args.epochs - 1`` of ``step`` over
    ``loader`` (the loader's next batch is prepared on a thread while the
    card computes, and ``prepare(batch)`` runs there too), each followed
    by ``checkpoints/<model_name>_<epoch>.ckpt`` with the per-batch
    losses of every epoch so far."""
    epoch_losses = metrics.get("epoch_losses", [])
    for epoch in range(start_epoch, args.epochs):
        batches = iter(loader)
        if prepare is not None:
            batches = map(prepare, batches)
        epoch_losses.append(train_epoch(
            step, host_prefetch(batches, size=2), epoch, args.epochs,
            len(loader), args.print_freq))
        save_checkpoint(args, epoch, encoder_to_jax(encoder),
                        decoder_to_jax(decoder), None,
                        adam_state_to_jax(optimizer, decoder, encoder),
                        {"epoch_losses": epoch_losses})


def as_device_tensor(array, device):
    """A numpy array (``to_device``) or a tensor as a tensor on
    ``device``."""
    if isinstance(array, torch.Tensor):
        return array.to(device)
    return to_device(array, device)


def eval_batches(loader, step, device, drain, length_offset=0, embed=None):
    """Run ``step(imgs, captions, caption_lengths - length_offset)`` on
    ``device`` over ``loader``'s batches, the inputs shipped on a thread
    while the card computes the previous batch, and hand each result to
    ``drain(per_sample_loss, preds, batch, batch_idx)`` on the host one
    batch late, so that the host's work overlaps the card's. With
    ``embed``, ``embed(batch)`` (run on that thread too) is the step's
    fourth input, on ``device``."""
    def staged():
        for batch in iter(loader):
            lengths = np.asarray(batch["caption_lengths"]) - length_offset
            inputs = [to_device(batch["imgs"], device),
                      to_device(batch["captions"], device),
                      to_device(lengths, device)]
            if embed is not None:
                inputs.append(as_device_tensor(embed(batch), device))
            yield inputs, batch

    pending = None
    for batch_idx, (inputs, batch) in enumerate(
            host_prefetch(staged(), size=2)):
        per_sample, preds = step(*inputs)
        if pending is not None:
            drain(*pending)
        pending = (per_sample, preds, batch, batch_idx)
    if pending is not None:
        drain(*pending)
