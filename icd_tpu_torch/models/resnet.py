"""ResNet-101 backbone (port of ``icd_tpu/models/resnet.py:37-259``).

Public functions keep the JAX package's NHWC layout. Internally a
convolution sees ``x.permute(0, 3, 1, 2)``: on a contiguous NHWC tensor
that view is NCHW in ``channels_last`` memory, which cuDNN takes as it
is, so the layout costs no copy. Convolutions and pooling are cuDNN /
ATen ops, as the JAX package leaves them to XLA (no Pallas kernel).

Parameter names follow the JAX tree: ``stem.conv``, ``stem.bn.scale``,
``layers.<stage>.<block>.conv1`` ... ``downsample.bn.var``. Conv
kernels are stored OIHW (the JAX tree is HWIO, see ``params.py``). BN
``mean``/``var`` are buffers and every other leaf a parameter, so
"cast the parameters" is ``_cast_keep_bn_stats`` (resnet.py:187).

Train mode (``resnet_forward(..., train=True)``) normalises with batch
statistics and returns the blended running statistics beside the
features, leaving the module as it is; ``merge_bn_stats`` writes them
back, as the JAX train step threads its new tree back
(``icd_tpu/training/common.py:115-137``).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.quant import div

RESNET101_DEPTHS = (3, 4, 23, 3)
RESNET_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch


# ---------------------------------------------------------------------------
# Functional ops (NHWC in, NHWC out)
# ---------------------------------------------------------------------------

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, stride=1, padding=0):
    """NHWC x OIHW convolution with symmetric padding (resnet.py:37)."""
    return _nhwc(F.conv2d(_nchw(x), w, stride=stride, padding=padding))


def batch_norm(x, bn, compute_dtype=None):
    """Eval-mode BatchNorm over NHWC channels (resnet.py:48, train=False).

    Scale and bias follow ``compute_dtype``; the running statistics stay
    at their stored dtype, so under bf16 the affine is computed in f32
    and only the result is rounded to the activation dtype.
    """
    scale, bias = bn.scale, bn.bias
    if compute_dtype is not None:
        scale, bias = scale.to(compute_dtype), bias.to(compute_dtype)
    inv = torch.rsqrt(bn.var + BN_EPS) * scale
    y = (x - bn.mean) * inv + bias
    return y.to(x.dtype)


def batch_norm_train(x, bn, compute_dtype=None):
    """Train-mode BatchNorm over NHWC channels (resnet.py:48, train=True):
    (y, {"mean", "var"}), the new running statistics.

    The batch statistics are taken at the running statistics' dtype and
    normalise with the biased variance; the running variance blends in
    the unbiased one with ``BN_MOMENTUM``, as torch tracks it. ``bn`` is
    not changed.
    """
    scale, bias = bn.scale, bn.bias
    if compute_dtype is not None:
        scale, bias = scale.to(compute_dtype), bias.to(compute_dtype)
    xs = x.to(bn.mean.dtype)
    mean = xs.mean(dim=(0, 1, 2))
    var = (xs - mean).square().mean(dim=(0, 1, 2))
    n = x.shape[0] * x.shape[1] * x.shape[2]
    unbiased = var * (n / max(n - 1, 1))
    stats = {"mean": (1 - BN_MOMENTUM) * bn.mean + BN_MOMENTUM * mean,
             "var": (1 - BN_MOMENTUM) * bn.var + BN_MOMENTUM * unbiased}
    inv = torch.rsqrt(var + BN_EPS) * scale
    y = (x - mean) * inv + bias
    return y.to(x.dtype), stats


def _bn(x, bn, compute_dtype, stats):
    """Eval-mode BN when ``stats`` is None; else train-mode BN, its new
    running statistics recorded in ``stats`` under the module."""
    if stats is None:
        return batch_norm(x, bn, compute_dtype)
    y, stats[bn] = batch_norm_train(x, bn, compute_dtype)
    return y


def merge_bn_stats(new_stats):
    """Write the running statistics of a train-mode forward into their
    BN modules (``icd_tpu/training/common.py:115``: only the statistics,
    cast to the stored dtype)."""
    with torch.no_grad():
        for bn, stats in new_stats.items():
            bn.mean.copy_(stats["mean"])
            bn.var.copy_(stats["var"])


def max_pool(x, window=3, stride=2, padding=1):
    """Max pooling over NHWC spatial dims, -inf padded (resnet.py:82).

    An integer tensor is padded with its dtype's minimum, as there, and
    pooled as the maximum over the window's shifted, strided slices:
    ATen's pooling takes no int8 on CUDA and fails on the CPU at real
    sizes.
    """
    if x.is_floating_point():
        return _nhwc(F.max_pool2d(_nchw(x), window, stride, padding))
    _, h, w, _ = x.shape
    x = F.pad(x, (0, 0, padding, padding, padding, padding),
              value=torch.iinfo(x.dtype).min)
    ho = (h + 2 * padding - window) // stride + 1
    wo = (w + 2 * padding - window) // stride + 1
    out = None
    for i in range(window):
        for j in range(window):
            s = x[:, i:i + stride * (ho - 1) + 1:stride,
                  j:j + stride * (wo - 1) + 1:stride]
            out = s if out is None else torch.maximum(out, s)
    return out


def adaptive_avg_pool2d(x, out_hw):
    """torch.nn.AdaptiveAvgPool2d on NHWC (resnet.py:93).

    The reference pools a 7x7 grid to (14, 14), which duplicates cells
    (models/encoder.py:92); ATen uses the same floor/ceil windows.
    """
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), out_hw))


def global_avg_pool(x):
    """Mean over the NHWC spatial dims (resnet.py:119), as ``jnp.mean``
    takes it: summed in f32 (bf16 input too), divided once, rounded once
    to the input's dtype. (ATen's mean on the card multiplies by the
    reciprocal of the count instead.)"""
    return div(x.float().sum(dim=(1, 2)), x.shape[1] * x.shape[2]).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class ConvBN(nn.Module):
    """``{"conv", "bn"}`` of the JAX tree (the stem and a downsample)."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bn = BatchNorm(cout)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride):
        super().__init__()
        cout = width * EXPANSION
        self.stride = stride
        self.conv1 = nn.Parameter(torch.empty(width, cin, 1, 1))
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Parameter(torch.empty(width, width, 3, 3))
        self.bn2 = BatchNorm(width)
        self.conv3 = nn.Parameter(torch.empty(cout, width, 1, 1))
        self.bn3 = BatchNorm(cout)
        self.downsample = (ConvBN(cin, cout, 1)
                           if stride != 1 or cin != cout else None)


class ResNet(nn.Module):
    def __init__(self, depths=RESNET101_DEPTHS, widths=RESNET_WIDTHS,
                 in_channels=3):
        super().__init__()
        self.depths, self.widths = tuple(depths), tuple(widths)
        self.stem = ConvBN(in_channels, widths[0], 7)
        self.layers = nn.ModuleList()
        cin = widths[0]
        for stage, (depth, width) in enumerate(zip(depths, widths)):
            blocks = nn.ModuleList()
            for b in range(depth):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(Bottleneck(cin, width, stride))
                cin = width * EXPANSION
            self.layers.append(blocks)


def init_resnet(generator, depths=RESNET101_DEPTHS, widths=RESNET_WIDTHS,
                in_channels=3, dtype=torch.float32, device=None):
    """Random-init a ResNet of the given depth config (resnet.py:142).

    Conv kernels are He-normal (std sqrt(2 / fan_in)), BN is identity.
    Values are drawn on the CPU from ``generator``, so a seed gives the
    same weights on every device.
    """
    device = resolve_device(device)
    net = ResNet(depths, widths, in_channels)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=generator)
                        * math.sqrt(2.0 / fan_in))
    return net.to(device=device, dtype=dtype)


def init_resnet101(generator, dtype=torch.float32, device=None):
    return init_resnet(generator, RESNET101_DEPTHS, RESNET_WIDTHS,
                       dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def cast_keep_bn_stats(module, dtype):
    """Copy of ``module`` with every parameter cast to ``dtype`` and the
    buffers (the BN running statistics) kept (resnet.py:187)."""
    import copy

    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            p.data = p.data.to(dtype)
    return out


def _w(p, compute_dtype):
    return p if compute_dtype is None else p.to(compute_dtype)


def _bottleneck(block, x, compute_dtype, conv=conv2d, stats=None):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with projection shortcut."""
    out = _bn(conv(x, _w(block.conv1, compute_dtype)),
              block.bn1, compute_dtype, stats).relu()
    out = _bn(conv(out, _w(block.conv2, compute_dtype),
                   stride=block.stride, padding=1),
              block.bn2, compute_dtype, stats).relu()
    out = _bn(conv(out, _w(block.conv3, compute_dtype)),
              block.bn3, compute_dtype, stats)
    if block.downsample is not None:
        shortcut = _bn(
            conv(x, _w(block.downsample.conv, compute_dtype),
                 stride=block.stride),
            block.downsample.bn, compute_dtype, stats)
    else:
        shortcut = x
    return (out + shortcut).relu()


def resnet_forward(resnet, x, compute_dtype=None, conv=None, train=False):
    """Run the backbone: NHWC in, NHWC features at stride 32 (resnet.py:230).

    In eval mode it returns the features. With ``train=True`` BN
    normalises with batch statistics and it returns (features,
    new_stats), ``new_stats`` mapping each BN module to its new running
    statistics (``merge_bn_stats`` stores them). ``compute_dtype`` casts the input
    and the parameters but not the BN statistics; a module already at
    that dtype (``cast_keep_bn_stats``) is used without a copy. With no
    ``compute_dtype`` the input takes the weights' dtype. ``conv``
    replaces ``conv2d`` (NHWC x OIHW, same arguments): calibration
    records each convolution's input through it, and
    ``ops.quant.int8_conv`` plugs in there.
    """
    if conv is None:
        conv = conv2d
    if compute_dtype is None:
        x = x.to(resnet.stem.conv.dtype)
    else:
        x = x.to(compute_dtype)
    stats = {} if train else None
    out = conv(x, _w(resnet.stem.conv, compute_dtype), stride=2, padding=3)
    out = _bn(out, resnet.stem.bn, compute_dtype, stats).relu()
    out = max_pool(out, window=3, stride=2, padding=1)
    for blocks in resnet.layers:
        for block in blocks:
            out = _bottleneck(block, out, compute_dtype, conv, stats)
    return out if stats is None else (out, stats)
