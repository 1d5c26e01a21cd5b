"""Attention encoder head (port of ``icd_tpu/models/encoder.py:47-72``
and :96-106).

The ResNet-101 grid adaptively pooled to 14x14x2048 for the
soft-attention decoder (reference: models/encoder.py:72-110), over the
float backbone or the static-int8 one (``resnet_int8.py``). The
baseline head (global pool + Linear, and its int8 form) comes with the
baseline slice.
"""

import torch
import torch.nn as nn

from ..ops.image import normalize_imagenet
from .resnet import adaptive_avg_pool2d, init_resnet101, resnet_forward
from .resnet_int8 import resnet_int8_forward

ENCODER_DIM = 2048
ATTENTION_GRID = (14, 14)


class EncoderAttention(nn.Module):
    """``{"resnet": ...}`` of the JAX tree."""

    def __init__(self, resnet):
        super().__init__()
        self.resnet = resnet


def init_encoder_attention(generator, dtype=torch.float32, device=None):
    return EncoderAttention(init_resnet101(generator, dtype, device))


def encoder_attention_forward(encoder, imgs, compute_dtype=None,
                              grid=ATTENTION_GRID):
    """(B, H, W, 3) uint8/float -> (B, gh, gw, 2048) grid, eval mode.

    uint8 input gets the ImageNet normalisation (encoder.py:67); float
    input is fed as it is. Unlike the JAX function this returns only
    the grid: eval-mode BN leaves the parameters unchanged.
    """
    x = normalize_imagenet(imgs) if imgs.dtype == torch.uint8 else imgs
    feats = resnet_forward(encoder.resnet, x, compute_dtype=compute_dtype)
    return adaptive_avg_pool2d(feats, grid)


def encoder_attention_forward_int8(qresnet, imgs, compute_dtype=torch.bfloat16,
                                   grid=ATTENTION_GRID):
    """``encoder_attention_forward`` over the static-int8 backbone
    (encoder.py:96): ``qresnet`` from ``resnet_int8.quantize_resnet``."""
    x = normalize_imagenet(imgs) if imgs.dtype == torch.uint8 else imgs
    feats = resnet_int8_forward(qresnet, x.to(compute_dtype),
                                out_dtype=compute_dtype)
    return adaptive_avg_pool2d(feats, grid)
