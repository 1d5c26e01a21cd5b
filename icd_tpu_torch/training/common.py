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

On a mesh (``parallel/mesh.py``) each data rank computes its share of
the global loss (the CE over the global count, one ``all_reduce`` of it;
the regulariser's mean over the number of ranks), the gradients of all
ranks are summed in one
flat bucket before clipping (the global gradient, then value clipping,
then Adam, as the JAX step orders them), and only global rank 0 prints
and writes checkpoints, from the decoder's gathered vocab shards.

AMP (``--amp``, compute dtype bf16): the trunk and the decoder compute
in bf16 on bf16 copies of their f32 parameters (``cast_floating``); the
loss, its log-softmax, the regulariser, the master weights, Adam's
moments and the BN statistics stay f32. ``torch.autocast`` is not used:
it keeps its own set of operations (the LSTM gates, the softmax, the
elementwise passes) in f32 where the JAX package computes in bf16.
"""

import copy
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..checkpoint import (async_saves, load_checkpoint, save_checkpoint,
                          unpack_checkpoint, wait_pending_saves)
from ..data.pipeline import (cached_batches, device_image_cache_from_env,
                             device_prefetch, host_prefetch, to_device)
from ..metric import AccumulatingMetric
from ..models.encoder import trainable_mask
from ..models.resnet import merge_bn_stats, resnet_forward
from ..models.resnet_int8 import calibrate_act_maxes, quantize_resnet
from ..ops.image import normalize_imagenet
from ..parallel.mesh import assert_replicated, shard_batch
from ..parallel.vocab import shard_decoder, unshard_decoder
from ..params import (adam_state_from_jax, adam_state_to_jax,
                      decoder_from_jax, decoder_to_jax, encoder_from_jax,
                      encoder_to_jax)
from ..utils.profiling import annotate, maybe_profile


class LossDrain:
    """Blocked loss fetcher for the per-batch-loss train loops
    (common.py:31).

    The reference records (and prints) a loss for every batch
    (models/baseline.py:245-258). Fetching each scalar makes the host
    wait for the card every step; the drain keeps the per-batch loss
    values and print lines unchanged while fetching ``block`` losses
    with one synchronisation (``torch.stack(...).tolist()``): 16, or
    ``ICD_TPU_LOSS_FETCH_BLOCK`` (common.py:58); 1 fetches every loss as
    its step is pushed.

    The per-batch "Time:" column is the dispatch-to-dispatch interval
    (host pacing). The wait of each block's fetch lands in the next
    batch's interval, so printed times oscillate around the true mean;
    the loss values are exact.
    """

    def __init__(self, finish, block=None):
        if block is None:
            block = int(os.environ.get("ICD_TPU_LOSS_FETCH_BLOCK", "16"))
        self.block = max(1, block)
        self.finish = finish  # finish(loss_val, batch_idx, dt_seconds)
        self._pending = []  # [(device_loss, batch_idx, dispatch_t)]
        self._last_t = time.time()

    def push(self, device_loss, batch_idx):
        now = time.time()
        self._pending.append((device_loss, batch_idx, now - self._last_t))
        self._last_t = now
        if len(self._pending) >= self.block:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        with annotate("train_drain"):
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


def global_count(count, group=None):
    """``count`` (an integer tensor) summed over the ranks of a data
    ``group``, as f32 (exact below 2^24): the denominator of a loss whose
    terms are split over the ranks. Without a group, ``count`` itself
    (the quotient is the same to the bit)."""
    if group is None:
        return count
    count = count.float()
    dist.all_reduce(count, group=group)
    return count


def cross_entropy(logits, targets, decode_lengths, group=None):
    """torch CrossEntropyLoss over the positions within each row's decode
    length (common.py:144): the sum of ``token_nll`` over them divided by
    their number, as pack_padded over the decode lengths gives it
    (attention.py:100-117); over a data ``group`` the number is the
    global batch's, so the ranks' losses sum to JAX's global one."""
    nll = token_nll(logits, targets, decode_lengths)
    return nll.sum() / global_count(decode_lengths.sum(), group).clamp(min=1)


def pad_cross_entropy(logits, targets, pad_idx, group=None):
    """torch ``CrossEntropyLoss(ignore_index=pad_idx)`` (common.py:144), in
    f32: the NLL summed over the positions whose target is not
    ``pad_idx``, divided by max(count, 1), the count over a data
    ``group``'s global batch when one is given. Padding a batch further
    with ``pad_idx`` changes neither the loss nor its gradients."""
    counted = targets != pad_idx
    return (torch.where(counted, _nll(logits, targets), 0.0).sum()
            / global_count(counted.sum(), group).clamp(min=1))


def doubly_stochastic_regularizer(alphas, alpha_c, group=None):
    """((alpha_c - sum_t alpha)^2).mean() (reference: attention.py:413-414).
    Over a data ``group`` it is the rank's share of the global batch's
    mean: its own mean over the number of ranks (the shares are equal)."""
    mean = ((alpha_c - alphas.sum(dim=1)) ** 2).mean()
    if group is None:
        return mean
    return mean / dist.get_world_size(group)


def reduce_gradients(optimizer, loss, group=None):
    """Sum the gradients of every parameter ``optimizer`` steps, and the
    rank's ``loss``, over a data ``group``: one flat bucket, one
    ``all_reduce``. Each rank's loss is its share of the global loss
    (the losses divide by global counts), so the sums are the global
    loss and its gradient. Returns the global loss, detached (the rank's
    own without a group)."""
    loss = loss.detach()
    if group is None:
        return loss
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(grads[0].dtype if grads
                                            else loss.dtype)])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1].to(loss.dtype)


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


def pretrained_resnet_or_none(device=None):
    """The backbone of ``models/resnet101.pth`` under ``ICD_TPU_ROOT``
    (torchvision's ResNet-101 weights, the file the reference expects,
    models/encoder.py:9-20) on ``device``, or None when there is no such
    file (baseline.py:59)."""
    from ..convert import load_resnet101_pth
    from ..params import resnet_from_jax
    from ..pathconf import _root

    path = os.path.join(_root(), "models", "resnet101.pth")
    if not os.path.exists(path):
        return None
    print("Loading pretrained ResNet-101 from {}".format(path))
    return resnet_from_jax(load_resnet101_pth(path)).to(device)


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


def make_adam(args, encoder, decoder, opt_state, head=False, mesh=None):
    """Adam over the trainable parameters (``trainable_parameters``) at
    the CLI's rates, its state loaded from a checkpoint's ``opt_state``
    when there is one (``params.adam_state_from_jax``), for the
    parameters this run trains. With ``--use_bert`` the decoder's table
    is frozen whatever ``--fine_tune_embedding`` says: BERT's embeddings
    replace it (attention.py:190-192). On a ``mesh`` the full decoder is
    then cut to this rank's vocab shards, and its Adam state with it
    (``parallel.vocab.shard_decoder``)."""
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
    if mesh is not None:
        shard_decoder(decoder, mesh, optimizer)
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


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tree_tensors(v)]
    return [tree]


def train_precision(args, resnet, loader, mesh=None):
    """(compute dtype, int8 trunk or None) of a train run: bf16 with
    --amp (else None: f32), and with --int8_encoder the trunk that
    ``prepare_int8_encoder`` makes (warmed up unless resuming). On a
    ``mesh`` every rank makes it from the whole warm-up batches, as the
    JAX package prepares it outside the mesh, and the trees and BN
    statistics are checked equal on every rank."""
    compute_dtype = torch.bfloat16 if getattr(args, "amp", False) else None
    qresnet = None
    if getattr(args, "int8_encoder", False):
        qresnet = prepare_int8_encoder(resnet, loader, compute_dtype,
                                       warmup=args.checkpoint is None)
        if mesh is not None:
            assert_replicated(_tree_tensors(qresnet) + list(resnet.buffers()),
                              "the --int8_encoder trunk")
    return compute_dtype, qresnet


def train_epoch(step, batches, epoch=0, epochs=1, num_batches=None,
                print_freq=1, verbose=True):
    """One epoch of ``step`` over ``batches`` (baseline.py:305-347,
    attention.py:243-310). ``step(batch)`` runs one train step on a
    batch, a dict of numpy arrays (the ``DataLoader``'s, or made in
    memory) or of tensors already on the device (``stage_batches``), and
    returns the loss on the device, not synchronised. Losses are fetched
    in blocks (``LossDrain``) and printed, unless not ``verbose``, as
    the JAX train loops print them. Returns the per-batch losses. Under
    a profiler each fetch of a batch is a span ``train_wait``, each step
    a ``train_step`` and each fetch of losses a ``train_drain``.
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
        if verbose and batch_idx % print_freq == 0:
            print("Epoch {}/{}, Batch {}/{}, Loss {:.4f}, Time: {:.4f}".format(
                epoch + 1, epochs, batch_idx + 1, num_batches,
                accum_loss.avg(), accum_time.val))

    drain = LossDrain(finish)
    batches = iter(batches)
    batch_idx = 0
    while True:
        with annotate("train_wait"):
            batch = next(batches, None)
        if batch is None:
            break
        with annotate("train_step"):
            loss = step(batch)
        drain.push(loss, batch_idx)
        batch_idx += 1
    drain.flush()
    return batch_losses


def is_lead(mesh):
    """Whether this process prints and writes checkpoints: global rank 0
    of a mesh's world, or the only process."""
    return mesh is None or not dist.is_initialized() or dist.get_rank() == 0


# The per-sample arrays of a loader batch, which a mesh rank cuts to its
# rows before they are shipped (BERT's ``embeddings`` arrive cut).
ROW_KEYS = ("imgs", "idx", "captions", "caption_lengths", "padded_lengths")


def rank_rows(mesh):
    """``batch -> batch`` keeping this rank's rows of ``ROW_KEYS`` (all
    rows without a ``mesh``) and the global batch size under ``n``."""
    def rows(batch):
        out = dict(batch, n=len(batch["captions"]))
        if mesh is not None:
            out.update(shard_batch({k: batch[k] for k in ROW_KEYS
                                    if k in batch}, mesh))
        return out
    return rows


def step_batch(batch, mesh=None):
    """(this rank's rows of a batch, the global batch size): a batch
    from ``stage_batches`` is already cut and carries ``n``; a loader
    batch is cut here."""
    if "n" not in batch:
        batch = rank_rows(mesh)(batch)
    return batch, batch["n"]


def stage_batches(loader, device, mesh=None, prepare=None, img_cache=None,
                  buf=None):
    """An epoch of ``loader``'s batches, staged for the train step: the
    loader and ``prepare(batch)`` (BERT's embeddings) run on a producer
    thread, which cuts a mesh rank's rows and ships them to ``device``
    ahead of the step (``device_prefetch``). With a ``DeviceImageCache``
    the producer ships only the images not yet in ``buf``, and each
    batch's ``imgs`` are inserted and gathered here, on the consumer's
    stream in step order (``cached_batches``), as the JAX step fuses
    them (pipeline.py:197-207)."""
    batches = iter(loader)
    if prepare is not None:
        batches = map(prepare, batches)
    if img_cache is None:
        yield from device_prefetch(map(rank_rows(mesh), batches), device)
        return
    for batch in cached_batches(batches, img_cache, device, rank_rows(mesh)):
        img_cache.insert(buf, batch.pop("fresh_slots"),
                         batch.pop("fresh_imgs"))
        batch["imgs"] = img_cache.gather(buf, batch.pop("idx"))
        yield batch


def checkpoint_snapshot(encoder, decoder, optimizer):
    """A callable returning the checkpoint's (encoder, decoder, Adam
    state) numpy trees (``checkpoint.save_checkpoint``'s ``snapshot``).
    For an async save (``ICD_TPU_CKPT_ASYNC``) it reads a device copy of
    the modules and the optimizer taken now, since the next step's Adam
    updates the parameters and moments in place; the writer thread then
    makes the host trees."""
    if async_saves():
        encoder, decoder, optimizer = copy.deepcopy(
            (encoder, decoder, optimizer))

    def trees():
        return (encoder_to_jax(encoder), decoder_to_jax(decoder),
                adam_state_to_jax(optimizer, decoder, encoder))
    return trees


def train_epochs(args, loader, step, encoder, decoder, optimizer,
                 start_epoch, metrics, prepare=None, mesh=None, device=None):
    """Epochs ``start_epoch`` to ``args.epochs - 1`` of ``step`` over
    ``loader`` (``stage_batches``: the next batches are read, prepared
    (``prepare(batch)``) and shipped to ``device`` on a thread while the
    card computes; through the device image cache with
    ``ICD_TPU_DEVICE_IMAGE_CACHE``), each followed by
    ``checkpoints/<model_name>_<epoch>.ckpt`` with the per-batch losses
    of every epoch so far (written on a background thread with
    ``ICD_TPU_CKPT_ASYNC``; all written when this returns). The run is
    traced with ``ICD_TPU_PROFILE`` (``utils.profiling``). On a ``mesh``
    every rank runs the epochs, each holding its own copy of the image
    cache; only global rank 0 prints and writes the checkpoint, after
    the decoder's vocab shards and their Adam state are gathered, so the
    file is the one a single device writes."""
    lead = is_lead(mesh)
    device = device if device is not None else mesh.device
    epoch_losses = metrics.get("epoch_losses", [])
    img_cache = device_image_cache_from_env(loader.dataset, args.batch_size)
    buf = None if img_cache is None else img_cache.init_buffer(device)
    name = "train_" + args.model_name
    if mesh is not None and dist.is_initialized() and not lead:
        name += "_rank{}".format(dist.get_rank())
    with maybe_profile(name):
        for epoch in range(start_epoch, args.epochs):
            epoch_losses.append(train_epoch(
                step, stage_batches(loader, device, mesh, prepare, img_cache,
                                    buf),
                epoch, args.epochs, len(loader), args.print_freq,
                verbose=lead))
            if mesh is not None:
                unshard_decoder(decoder, mesh, optimizer)
            if lead:
                with annotate("checkpoint"):
                    save_checkpoint(
                        args, epoch, None, None, None, None,
                        {"epoch_losses": epoch_losses},
                        snapshot=checkpoint_snapshot(encoder, decoder,
                                                     optimizer))
            if mesh is not None:
                shard_decoder(decoder, mesh, optimizer)
    wait_pending_saves()


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
