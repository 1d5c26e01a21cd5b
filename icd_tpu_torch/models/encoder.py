"""CNN encoder heads over the ResNet-101 backbone
(port of ``icd_tpu/models/encoder.py:26-161``).

- ``encoder_forward``: global-pooled features -> Linear(2048,
  embed_size), (B, embed_size) for the baseline LSTM decoder
  (reference: models/encoder.py:22-58);
- ``encoder_attention_forward``: the grid adaptively pooled to
  14x14x2048 for the soft-attention decoder (reference:
  models/encoder.py:72-110).

Each over the float backbone or the static-int8 one
(``resnet_int8.py``); the attention grid also in train mode, which
returns the backbone's new BN statistics. ``trainable_mask`` says which
parameters take gradients. The ``embed`` product and its bias are two
operations, as JAX's ``x @ w + b``: in bf16 ``F.linear`` with a bias
would add it before the product's one rounding.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.image import normalize_imagenet
from .resnet import (adaptive_avg_pool2d, global_avg_pool, init_resnet101,
                     resnet_forward)
from .resnet_int8 import resnet_int8_forward

ENCODER_DIM = 2048
ATTENTION_GRID = (14, 14)


class Encoder(nn.Module):
    """``{"resnet": ..., "embed": ...}`` of the JAX tree; ``embed`` is an
    ``nn.Linear(2048, embed_size)``."""

    def __init__(self, resnet, embed):
        super().__init__()
        self.resnet = resnet
        self.embed = embed


def init_embed(generator, embed_size, dtype=torch.float32, device=None):
    """The baseline head, a torch-default ``nn.Linear(2048, embed_size)``:
    U(+-1/sqrt(2048)) on weight and bias (encoder.py:30), drawn from
    ``generator`` on the CPU."""
    device = resolve_device(device)
    embed = nn.Linear(ENCODER_DIM, embed_size)
    bound = 1.0 / math.sqrt(ENCODER_DIM)
    with torch.no_grad():
        for p in (embed.weight, embed.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound)
                    - bound)
    return embed.to(device=device, dtype=dtype)


def init_encoder(generator, embed_size, dtype=torch.float32, device=None):
    """ResNet-101 and the baseline head (encoder.py:39)."""
    return Encoder(init_resnet101(generator, dtype, device),
                   init_embed(generator, embed_size, dtype, device))


def _embed(embed, pooled):
    return F.linear(pooled.to(embed.weight.dtype), embed.weight) + embed.bias


def encoder_forward(encoder, imgs, compute_dtype=None, conv=None):
    """(B, H, W, 3) uint8/float -> (B, embed_size) features, eval mode
    (encoder.py:51). ``conv`` replaces the backbone's convolution (the
    dynamic ``ops.quant.int8_conv``). Unlike the JAX function this
    returns only the features, as ``encoder_attention_forward`` does."""
    x = normalize_imagenet(imgs) if imgs.dtype == torch.uint8 else imgs
    feats = resnet_forward(encoder.resnet, x, compute_dtype=compute_dtype,
                           conv=conv)
    return _embed(encoder.embed, global_avg_pool(feats))


def encoder_forward_int8(encoder, qresnet, imgs, compute_dtype=torch.bfloat16):
    """``encoder_forward`` over the static-int8 backbone ``qresnet``
    (encoder.py:75); only ``encoder.embed`` is read."""
    x = normalize_imagenet(imgs) if imgs.dtype == torch.uint8 else imgs
    feats = resnet_int8_forward(qresnet, x.to(compute_dtype),
                                out_dtype=compute_dtype)
    return _embed(encoder.embed, global_avg_pool(feats))


class EncoderAttention(nn.Module):
    """``{"resnet": ...}`` of the JAX tree."""

    def __init__(self, resnet):
        super().__init__()
        self.resnet = resnet


def init_encoder_attention(generator, dtype=torch.float32, device=None):
    return EncoderAttention(init_resnet101(generator, dtype, device))


def encoder_attention_forward(encoder, imgs, compute_dtype=None,
                              grid=ATTENTION_GRID, train=False):
    """(B, H, W, 3) uint8/float -> (B, gh, gw, 2048) grid (encoder.py:64).

    uint8 input gets the ImageNet normalisation (encoder.py:67); float
    input is fed as it is. In eval mode this returns only the grid, as
    BN leaves the parameters unchanged; with ``train=True`` it returns
    (grid, new_stats), the backbone's new BN running statistics
    (``resnet.merge_bn_stats`` stores them).
    """
    x = normalize_imagenet(imgs) if imgs.dtype == torch.uint8 else imgs
    out = resnet_forward(encoder.resnet, x, compute_dtype=compute_dtype,
                         train=train)
    if not train:
        return adaptive_avg_pool2d(out, grid)
    feats, stats = out
    return adaptive_avg_pool2d(feats, grid), stats


def encoder_attention_forward_int8(qresnet, imgs, compute_dtype=torch.bfloat16,
                                   grid=ATTENTION_GRID):
    """``encoder_attention_forward`` over the static-int8 backbone
    (encoder.py:96): ``qresnet`` from ``resnet_int8.quantize_resnet``."""
    x = normalize_imagenet(imgs) if imgs.dtype == torch.uint8 else imgs
    feats = resnet_int8_forward(qresnet, x.to(compute_dtype),
                                out_dtype=compute_dtype)
    return adaptive_avg_pool2d(feats, grid)


def trainable_mask(encoder, fine_tune=False):
    """{parameter name: takes gradients} over ``encoder`` (encoder.py:109,
    with ``head=False``: the attention encoder has no head).

    The backbone is frozen (reference: encoder.py:42-43); ``fine_tune``
    unfreezes stages 2-4 (``layers.1`` to ``layers.3``: children[5:],
    reference: encoder.py:60-69), convolutions and BN scale and bias.
    The BN running statistics are buffers, never trained.
    """
    mask = {}
    for name, _ in encoder.named_parameters():
        parts = name.split(".")  # resnet.layers.<stage>...
        mask[name] = (fine_tune and parts[:2] == ["resnet", "layers"]
                      and int(parts[2]) >= 1)
    return mask
