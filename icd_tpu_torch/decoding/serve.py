"""Batched beam-search serving on one card (the single-card counterpart
of ``icd_tpu/decoding/serve.py:398-428`` and of the float path of
``tools/beam_eval.py:130-136``).

uint8 NHWC images -> ImageNet normalisation -> ResNet-101 grid -> a beam
search, all on the card in ``compute_dtype``. The beam search is
``beam_search_batched`` (one K1 launch a step) unless the caller passes
another function of the same signature, such as
``ops.fused_beam.beam_search_fused`` (the whole search in one K2
launch), as ``tools/beam_eval.py:76-85`` swaps it.
"""

import copy

import torch

from ..device import resolve_device, use_exact_f32
from ..models.encoder import encoder_attention_forward
from ..models.resnet import cast_keep_bn_stats
from .beam import beam_search_batched


class BeamCaptioner:
    """``captioner(imgs)`` -> the ``beam_search_batched`` dict.

    ``encode`` and ``decode`` are its two halves, for timing them apart.
    """

    def __init__(self, encoder, decoder, start_id, end_id, beam_size,
                 compute_dtype, device, beam_fn=beam_search_batched):
        self.encoder, self.decoder = encoder, decoder
        self.start_id, self.end_id = start_id, end_id
        self.beam_size = beam_size
        self.compute_dtype = compute_dtype
        self.device = device
        self.beam_fn = beam_fn

    @torch.inference_mode()
    def encode(self, imgs):
        """(B, H, W, 3) uint8 -> (B, 14, 14, D) grid in compute_dtype."""
        imgs = torch.as_tensor(imgs).to(self.device)
        return encoder_attention_forward(
            self.encoder, imgs, compute_dtype=self.compute_dtype)

    @torch.inference_mode()
    def decode(self, grid):
        return self.beam_fn(
            self.decoder, grid.to(self.compute_dtype), self.beam_size,
            self.start_id, self.end_id)

    def __call__(self, imgs):
        return self.decode(self.encode(imgs))


def make_beam_captioner(encoder, decoder, start_id, end_id, beam_size=5,
                        compute_dtype=torch.bfloat16, device=None,
                        beam_fn=beam_search_batched):
    """Build the captioner on ``device`` (cuda unless told otherwise).

    The encoder's parameters are cast to ``compute_dtype`` once, its BN
    statistics kept at their stored dtype (as ``compute_dtype`` does in
    ``encoder_attention_forward``), and its kernels stored
    ``channels_last`` for cuDNN; the decoder is cast whole, as
    ``serve.py``'s ``_cast_tree`` does. With f32 the port turns TF32 off
    (``device.use_exact_f32``). The caller's modules are not modified.
    """
    device = resolve_device(device)
    if compute_dtype == torch.float32:
        use_exact_f32()
    enc = cast_keep_bn_stats(encoder, compute_dtype).to(device)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
    dec = copy.deepcopy(decoder).to(device=device, dtype=compute_dtype)
    return BeamCaptioner(enc.eval(), dec.eval(), start_id, end_id,
                         beam_size, compute_dtype, device, beam_fn)
