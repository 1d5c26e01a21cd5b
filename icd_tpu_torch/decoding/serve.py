"""Serving on one card: uint8 images in, captions out
(the single-card counterparts of ``icd_tpu/decoding/serve.py:29-269`` and
:398-428, and of ``tools/beam_eval.py:102-136``).

uint8 NHWC images -> ImageNet normalisation -> ResNet-101 (float, or the
static-int8 backbone of ``models/resnet_int8.py``) -> a 14x14 grid and a
beam search or greedy decoding (attention model), or pooled features
and greedy decoding (baseline model), all on the card in
``compute_dtype``.

- ``make_beam_captioner``: the beam search is ``beam_search_batched``
  (one K1 launch a step) unless the caller passes another function of
  the same signature, such as ``ops.fused_beam.beam_search_fused`` (the
  whole search in one K2 launch), as ``tools/beam_eval.py:76-85`` swaps
  it. Given a quantized tree, ``act_maxes`` or ``calib_imgs``, its
  encoder is the int8 one (``tools/beam_eval.py:102-128``).
- ``make_attention_captioner`` and ``make_int8_attention_captioner``:
  greedy decoding (``decoding/greedy_attention.py``), the latter over
  the int8 backbone and, with ``int8_decoder``, W8A8 LSTM and fc
  products.
- ``make_captioner`` (float backbone, or with ``int8`` its convolutions
  through the dynamic ``ops.quant.int8_conv``) and
  ``make_int8_captioner`` (static-int8 backbone; ``int8_decoder`` for
  W8A8 LSTM and linear products): the baseline model,
  ``decoding/greedy.py``. ``make_repeat_captioner`` and
  ``make_int8_repeat_captioner`` caption ``repeats`` perturbed copies of
  a batch in one call and return a token checksum (the bench's unit of
  work, ``icd_tpu_torch/bench.py``).
- ``make_sharded_captioner``, ``make_sharded_attention_captioner`` and
  ``make_sharded_beam_captioner`` (serve.py:272-428): the same
  captioners on a mesh's data ranks (``ShardedCaptioner``).
"""

import copy

import torch
import torch.distributed as dist

from ..device import resolve_device, use_exact_f32
from ..models.encoder import (Encoder, encoder_attention_forward,
                              encoder_attention_forward_int8,
                              encoder_forward, encoder_forward_int8)
from ..models.resnet import cast_keep_bn_stats
from ..models.resnet_int8 import (calibrate_act_maxes, quantize_resnet,
                                  tree_to)
from ..ops.quant import int8_conv
from ..parallel.mesh import batch_layout, gather_batch
from ..utils.profiling import annotate
from .beam import beam_search_batched
from .greedy import (greedy_decode_baseline, greedy_decode_baseline_int8,
                     quantize_baseline_decoder)
from .greedy_attention import (greedy_decode_attention,
                               greedy_decode_attention_int8,
                               quantize_attention_decoder)


class Captioner:
    """``captioner(imgs)`` -> ``decode(encode(imgs))``; the two halves are
    public, for timing them apart. ``qresnet`` (the int8 tree) selects
    the int8 encoder, and ``act_maxes`` are the calibrated maxes it was
    built from (None for the float encoder)."""

    def __init__(self, encoder, decoder, start_id, end_id, compute_dtype,
                 device, qresnet=None, act_maxes=None):
        self.encoder, self.decoder = encoder, decoder
        self.start_id, self.end_id = start_id, end_id
        self.compute_dtype = compute_dtype
        self.device = device
        self.qresnet, self.act_maxes = qresnet, act_maxes

    @torch.inference_mode()
    def encode(self, imgs):
        """(B, H, W, 3) uint8 -> (B, 14, 14, D) grid in compute_dtype; the
        upload is a span ``serve_upload`` under a profiler."""
        with annotate("serve_upload"):
            imgs = torch.as_tensor(imgs).to(self.device)
        if self.qresnet is not None:
            return encoder_attention_forward_int8(self.qresnet, imgs,
                                                  self.compute_dtype)
        return encoder_attention_forward(
            self.encoder, imgs, compute_dtype=self.compute_dtype)

    def __call__(self, imgs):
        return self.decode(self.encode(imgs))


class BeamCaptioner(Captioner):
    """``captioner(imgs)`` -> the ``beam_search_batched`` dict."""

    def __init__(self, encoder, decoder, start_id, end_id, beam_size,
                 compute_dtype, device, beam_fn=beam_search_batched,
                 qresnet=None, act_maxes=None):
        super().__init__(encoder, decoder, start_id, end_id, compute_dtype,
                         device, qresnet, act_maxes)
        self.beam_size = beam_size
        self.beam_fn = beam_fn

    @torch.inference_mode()
    def decode(self, grid):
        return self.beam_fn(
            self.decoder, grid.to(self.compute_dtype), self.beam_size,
            self.start_id, self.end_id)


class GreedyCaptioner(Captioner):
    """``captioner(imgs)`` -> (tokens (B, max_len), alphas (B, max_len, P)),
    as the JAX package's greedy captioners return. ``qdec`` (the int8
    decoder tree) selects ``greedy_decode_attention_int8``."""

    def __init__(self, encoder, decoder, start_id, end_id, max_len,
                 compute_dtype, device, qresnet=None, act_maxes=None,
                 qdec=None):
        super().__init__(encoder, decoder, start_id, end_id, compute_dtype,
                         device, qresnet, act_maxes)
        self.max_len = max_len
        self.qdec = qdec

    @torch.inference_mode()
    def decode(self, grid):
        grid = grid.to(self.compute_dtype)
        if self.qdec is not None:
            return greedy_decode_attention_int8(
                self.decoder, self.qdec, grid, self.start_id, self.end_id,
                max_len=self.max_len)
        return greedy_decode_attention(self.decoder, grid, self.start_id,
                                       self.end_id, max_len=self.max_len)


class BaselineCaptioner(Captioner):
    """``captioner(imgs)`` -> (B, max_len) tokens of the baseline model.
    ``encoder`` is the cast ``Encoder`` (only its ``embed`` is read with
    ``qresnet``); ``conv`` replaces the float backbone's convolution;
    ``qdec`` (the int8 decoder tree) selects
    ``greedy_decode_baseline_int8``."""

    def __init__(self, encoder, decoder, start_id, end_id, max_len,
                 compute_dtype, device, qresnet=None, act_maxes=None,
                 qdec=None, conv=None):
        super().__init__(encoder, decoder, start_id, end_id, compute_dtype,
                         device, qresnet, act_maxes)
        self.max_len = max_len
        self.qdec, self.conv = qdec, conv

    @torch.inference_mode()
    def encode(self, imgs):
        """(B, H, W, 3) uint8 -> (B, embed_size) features in
        compute_dtype; the upload is a span ``serve_upload``."""
        with annotate("serve_upload"):
            imgs = torch.as_tensor(imgs).to(self.device)
        if self.qresnet is not None:
            return encoder_forward_int8(self.encoder, self.qresnet, imgs,
                                        self.compute_dtype)
        return encoder_forward(self.encoder, imgs,
                               compute_dtype=self.compute_dtype,
                               conv=self.conv).to(self.compute_dtype)

    @torch.inference_mode()
    def decode(self, feats):
        if self.qdec is not None:
            return greedy_decode_baseline_int8(
                self.qdec, feats, self.start_id, self.end_id,
                max_len=self.max_len)
        return greedy_decode_baseline(
            self.decoder, feats.to(self.compute_dtype), self.start_id,
            self.end_id, max_len=self.max_len)


class RepeatCaptioner:
    """``captioner(imgs, salt)`` -> the int32 sum of the tokens of
    ``repeats`` perturbed copies of the batch, ``imgs + (i + salt)`` in
    uint8 with wrap-around for i < repeats (serve.py:214). ``encode``,
    ``decode`` and ``act_maxes`` are those of the one-batch
    ``captioner``."""

    def __init__(self, captioner, repeats):
        self.captioner, self.repeats = captioner, repeats
        self.encode, self.decode = captioner.encode, captioner.decode
        self.act_maxes = captioner.act_maxes

    @torch.inference_mode()
    def __call__(self, imgs, salt):
        imgs = torch.as_tensor(imgs).to(self.captioner.device)
        total = torch.zeros((), dtype=torch.int64, device=imgs.device)
        for i in range(self.repeats):
            total += self.captioner(imgs + (i + int(salt)) % 256).sum()
        return total.to(torch.int32)


def _device_encoder(encoder, compute_dtype, device, keep_bn_stats):
    """A copy of the float encoder on ``device``: parameters cast to
    ``compute_dtype`` (the BN statistics too unless ``keep_bn_stats``),
    conv kernels stored ``channels_last`` for cuDNN."""
    if keep_bn_stats:
        enc = cast_keep_bn_stats(encoder, compute_dtype).to(device)
    else:
        enc = copy.deepcopy(encoder).to(device=device, dtype=compute_dtype)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
    return enc.eval()


def build_int8_backbone(encoder, compute_dtype, device, calib_imgs=None,
                        act_maxes=None):
    """Calibrate (unless ``act_maxes`` is given) and quantize the
    encoder's backbone (serve.py:85): (qresnet on ``device``,
    act_maxes). Calibration runs ``encoder`` as it is given, at
    ``compute_dtype``, on ``device``, over ``calib_imgs`` (one batch or
    an iterable of batches)."""
    resnet = encoder.resnet
    if act_maxes is None:
        if calib_imgs is None:
            raise ValueError(
                "int8 serving needs calib_imgs (batches of images) or "
                "precomputed act_maxes")
        resnet = copy.deepcopy(resnet).to(device).eval()
        act_maxes = calibrate_act_maxes(resnet, calib_imgs, compute_dtype)
    return tree_to(quantize_resnet(resnet, act_maxes), device), act_maxes


def make_beam_captioner(encoder, decoder, start_id, end_id, beam_size=5,
                        compute_dtype=torch.bfloat16, device=None,
                        beam_fn=beam_search_batched, qresnet=None,
                        calib_imgs=None, act_maxes=None):
    """Build the beam captioner on ``device`` (cuda unless told otherwise).

    The float encoder's parameters are cast to ``compute_dtype`` once, its
    BN statistics kept at their stored dtype (as ``compute_dtype`` does
    in ``encoder_attention_forward``), and its kernels stored
    ``channels_last`` for cuDNN. A quantized tree ``qresnet``, or
    ``act_maxes``, or ``calib_imgs`` to calibrate on, selects the
    static-int8 encoder instead (``build_int8_backbone``), which works
    with either ``beam_fn``. The decoder is cast whole, as ``serve.py``'s
    ``_cast_tree`` does. With f32 the port turns TF32 off
    (``device.use_exact_f32``). The caller's modules are not modified.
    """
    device = resolve_device(device)
    if compute_dtype == torch.float32:
        use_exact_f32()
    if qresnet is not None:
        enc, int8 = None, (tree_to(qresnet, device), act_maxes)
    elif act_maxes is None and calib_imgs is None:
        enc, int8 = _device_encoder(encoder, compute_dtype, device,
                                    keep_bn_stats=True), (None, None)
    else:
        enc, int8 = None, build_int8_backbone(
            encoder, compute_dtype, device, calib_imgs, act_maxes)
    dec = copy.deepcopy(decoder).to(device=device, dtype=compute_dtype)
    return BeamCaptioner(enc, dec.eval(), start_id, end_id, beam_size,
                         compute_dtype, device, beam_fn, *int8)


def make_attention_captioner(encoder, decoder, start_id, end_id, max_len=25,
                             compute_dtype=torch.bfloat16, device=None):
    """Greedy captioner of the soft-attention model (serve.py:136):
    ``captioner(imgs)`` -> (tokens, alphas). Encoder and decoder are cast
    whole to ``compute_dtype``, BN statistics included, as ``_cast_tree``
    does there."""
    device = resolve_device(device)
    if compute_dtype == torch.float32:
        use_exact_f32()
    enc = _device_encoder(encoder, compute_dtype, device,
                          keep_bn_stats=False)
    dec = copy.deepcopy(decoder).to(device=device, dtype=compute_dtype)
    return GreedyCaptioner(enc, dec.eval(), start_id, end_id, max_len,
                           compute_dtype, device)


def make_int8_attention_captioner(encoder, decoder, start_id, end_id,
                                  max_len=25, compute_dtype=torch.bfloat16,
                                  calib_imgs=None, act_maxes=None,
                                  int8_decoder=False, device=None):
    """Static-int8 backbone + soft-attention greedy decoding
    (serve.py:158). Pass image batches as ``calib_imgs`` or saved
    ``act_maxes``; the result's ``act_maxes`` are the ones used.

    ``int8_decoder`` also quantizes the decode loop's LSTM gates and
    vocab projection from the decoder's full-precision weights
    (``ops/qlinear.py``); their float copies are not moved to the card.
    """
    device = resolve_device(device)
    if compute_dtype == torch.float32:
        use_exact_f32()
    qresnet, act_maxes = build_int8_backbone(encoder, compute_dtype, device,
                                             calib_imgs, act_maxes)
    dec = copy.deepcopy(decoder)
    qdec = None
    if int8_decoder:
        qdec = tree_to(quantize_attention_decoder(decoder), device)
        dec.lstm = None
        dec.fc = None
    dec = dec.to(device=device, dtype=compute_dtype).eval()
    return GreedyCaptioner(None, dec, start_id, end_id, max_len,
                           compute_dtype, device, qresnet, act_maxes, qdec)


def _baseline_decoder(decoder, compute_dtype, device, int8_decoder):
    """(float decoder, int8 tree) on ``device``, one of them None
    (serve.py:29). The int8 tree is quantized from the decoder's
    full-precision weights, its embedding cast to ``compute_dtype``."""
    if not int8_decoder:
        dec = copy.deepcopy(decoder).to(device=device, dtype=compute_dtype)
        return dec.eval(), None
    qdec = quantize_baseline_decoder(decoder)
    qdec["embedding"] = qdec["embedding"].to(compute_dtype)
    return None, tree_to(qdec, device)


def make_captioner(encoder, decoder, start_id, end_id, max_len=25,
                   compute_dtype=torch.bfloat16, int8=False, device=None):
    """Greedy captioner of the baseline model (serve.py:56):
    ``captioner(imgs)`` -> tokens. Encoder and decoder are cast whole to
    ``compute_dtype``, BN statistics included, as ``_cast_tree`` does
    there. ``int8`` runs the backbone's convolutions through the dynamic
    W8A8 ``ops.quant.int8_conv``."""
    device = resolve_device(device)
    if compute_dtype == torch.float32:
        use_exact_f32()
    enc = _device_encoder(encoder, compute_dtype, device,
                          keep_bn_stats=False)
    dec, _ = _baseline_decoder(decoder, compute_dtype, device, False)
    return BaselineCaptioner(enc, dec, start_id, end_id, max_len,
                             compute_dtype, device,
                             conv=int8_conv if int8 else None)


def make_int8_captioner(encoder, decoder, start_id, end_id, max_len=25,
                        compute_dtype=torch.bfloat16, calib_imgs=None,
                        act_maxes=None, int8_decoder=False, device=None):
    """Static-int8 backbone + baseline greedy decoding (serve.py:101).
    Pass image batches as ``calib_imgs`` or saved ``act_maxes``; the
    result's ``act_maxes`` are the ones used. The backbone is calibrated
    and quantized from the encoder's full-precision weights; only
    ``embed`` is cast. ``int8_decoder`` quantizes the LSTM gates and the
    vocab projection (``ops/qlinear.py``)."""
    device = resolve_device(device)
    if compute_dtype == torch.float32:
        use_exact_f32()
    qresnet, act_maxes = build_int8_backbone(encoder, compute_dtype, device,
                                             calib_imgs, act_maxes)
    head = Encoder(None, copy.deepcopy(encoder.embed).to(
        device=device, dtype=compute_dtype))
    dec, qdec = _baseline_decoder(decoder, compute_dtype, device,
                                  int8_decoder)
    return BaselineCaptioner(head, dec, start_id, end_id, max_len,
                             compute_dtype, device, qresnet, act_maxes, qdec)


def make_repeat_captioner(encoder, decoder, start_id, end_id, max_len=25,
                          compute_dtype=torch.bfloat16, repeats=10,
                          device=None):
    """``make_captioner`` as a ``RepeatCaptioner`` (serve.py:214)."""
    return RepeatCaptioner(make_captioner(
        encoder, decoder, start_id, end_id, max_len, compute_dtype,
        device=device), repeats)


def make_int8_repeat_captioner(encoder, decoder, start_id, end_id,
                               max_len=25, compute_dtype=torch.bfloat16,
                               repeats=10, calib_imgs=None, act_maxes=None,
                               int8_decoder=False, device=None):
    """``make_int8_captioner`` as a ``RepeatCaptioner`` (serve.py:241)."""
    return RepeatCaptioner(make_int8_captioner(
        encoder, decoder, start_id, end_id, max_len, compute_dtype,
        calib_imgs, act_maxes, int8_decoder, device), repeats)


class ShardedCaptioner:
    """A one-card ``captioner`` on a mesh's data ranks (serve.py:272):
    its weights on every rank, each data rank captioning its rows of the
    batch (``parallel.batch_rows``) and the ranks' outputs gathered into
    the batch's, in row order (``parallel.gather_batch``), on every rank.
    A batch that does not divide over the data ranks is captioned whole
    on each. The greedy loops may stop on one rank before another: a
    finished caption emits ``end_id`` from then on, so its tokens are
    the same. A beam search's ``steps`` is the most any data rank ran,
    as JAX's one vmapped loop counts it."""

    def __init__(self, captioner, mesh):
        self.captioner, self.mesh = captioner, mesh
        self.act_maxes = captioner.act_maxes

    @torch.inference_mode()
    def __call__(self, imgs):
        rows, group = batch_layout(self.mesh, len(imgs))
        out = self.captioner(imgs[rows])
        if group is None:
            return out
        if isinstance(out, tuple):
            return tuple(gather_batch(x, self.mesh) for x in out)
        if isinstance(out, dict):
            steps = torch.tensor(out["steps"], device=out["seq"].device)
            dist.all_reduce(steps, op=dist.ReduceOp.MAX, group=group)
            return dict({key: gather_batch(value, self.mesh)
                         for key, value in out.items() if key != "steps"},
                        steps=int(steps))
        return gather_batch(out, self.mesh)


def make_sharded_captioner(encoder, decoder, start_id, end_id, mesh,
                           max_len=25, compute_dtype=torch.bfloat16,
                           int8=False, calib_imgs=None, act_maxes=None,
                           int8_decoder=False):
    """The baseline model's greedy captioner on ``mesh``'s data ranks
    (serve.py:272): the float encoder cast whole, or with ``int8`` the
    static-int8 backbone (``calib_imgs`` or ``act_maxes``, as
    ``make_int8_captioner``) and its cast ``embed``; the float decoder,
    or with ``int8_decoder`` the W8A8 one. Weights on every rank, on
    ``mesh.device``."""
    device = mesh.device
    if compute_dtype == torch.float32:
        use_exact_f32()
    qresnet = None
    if int8:
        qresnet, act_maxes = build_int8_backbone(
            encoder, compute_dtype, device, calib_imgs, act_maxes)
        head = Encoder(None, copy.deepcopy(encoder.embed).to(
            device=device, dtype=compute_dtype))
    else:
        head = _device_encoder(encoder, compute_dtype, device,
                               keep_bn_stats=False)
    dec, qdec = _baseline_decoder(decoder, compute_dtype, device,
                                  int8_decoder)
    return ShardedCaptioner(BaselineCaptioner(
        head, dec, start_id, end_id, max_len, compute_dtype, device,
        qresnet, act_maxes if int8 else None, qdec), mesh)


def make_sharded_attention_captioner(encoder, decoder, start_id, end_id,
                                     mesh, max_len=25,
                                     compute_dtype=torch.bfloat16,
                                     int8=False, calib_imgs=None,
                                     act_maxes=None):
    """The attention model's greedy captioner on ``mesh``'s data ranks
    (serve.py:371): ``make_attention_captioner``, or with ``int8``
    ``make_int8_attention_captioner``'s static-int8 backbone; each rank's
    decode steps take their attention from K1. Returns (tokens,
    alphas) of the batch."""
    if int8:
        captioner = make_int8_attention_captioner(
            encoder, decoder, start_id, end_id, max_len, compute_dtype,
            calib_imgs, act_maxes, device=mesh.device)
    else:
        captioner = make_attention_captioner(
            encoder, decoder, start_id, end_id, max_len, compute_dtype,
            device=mesh.device)
    return ShardedCaptioner(captioner, mesh)


def make_sharded_beam_captioner(encoder, decoder, start_id, end_id, mesh,
                                beam_size=5, compute_dtype=torch.bfloat16,
                                int8=False, calib_imgs=None, act_maxes=None):
    """Beam search on ``mesh``'s data ranks (serve.py:398): the per-step
    ``beam_search_batched`` (one K1 launch a step on each rank) over the
    float encoder cast whole, as ``_replicated_attention_fwd`` casts it,
    or with ``int8`` the static-int8 backbone. Returns the
    ``beam_search_batched`` dict of the batch."""
    device = mesh.device
    if compute_dtype == torch.float32:
        use_exact_f32()
    if int8:
        enc = None
        qresnet, act_maxes = build_int8_backbone(
            encoder, compute_dtype, device, calib_imgs, act_maxes)
    else:
        enc = _device_encoder(encoder, compute_dtype, device,
                              keep_bn_stats=False)
        qresnet, act_maxes = None, None
    dec = copy.deepcopy(decoder).to(device=device, dtype=compute_dtype)
    return ShardedCaptioner(BeamCaptioner(
        enc, dec.eval(), start_id, end_id, beam_size, compute_dtype, device,
        qresnet=qresnet, act_maxes=act_maxes), mesh)
