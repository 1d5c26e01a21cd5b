"""ResNet-101 backbone (port of ``icd_tpu/models/resnet.py:37-259``).

Public functions keep the JAX package's NHWC layout. Internally a
convolution sees ``x.permute(0, 3, 1, 2)``: on a contiguous NHWC tensor
that view is NCHW in ``channels_last`` memory, which cuDNN takes as it
is, so the layout costs no copy. Convolutions and pooling are cuDNN /
ATen ops, as the JAX package leaves them to XLA (no Pallas kernel).
Eval-mode BN with its ReLU and residual add is one pass of K3 on the
card (``bn_relu``, ``ops/bn_epilogue.py``), where XLA fuses them.

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
import weakref

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.bn_epilogue import Terms, bn_epilogue
from ..ops.quant import div

RESNET101_DEPTHS = (3, 4, 23, 3)
RESNET_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5  # every BN of the trunk (torch.nn.BatchNorm2d's default)
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


def bn_terms(bn, compute_dtype=None):
    """Eval-mode BN's terms (mean, var, scale, bias, eps) (resnet.py:48,
    train=False): ``(x - mean) * rsqrt(var + eps) * scale + bias``.

    Scale and bias follow ``compute_dtype``; the running statistics stay
    at their stored dtype, so under bf16 with f32 statistics the affine
    is computed in f32 and only the result is rounded to the activation
    dtype.
    """
    scale, bias = bn.scale, bn.bias
    if compute_dtype is not None and scale.dtype != compute_dtype:
        scale = scale.to(compute_dtype)
    if compute_dtype is not None and bias.dtype != compute_dtype:
        bias = bias.to(compute_dtype)
    return bn.mean, bn.var, scale, bias, BN_EPS


_K3_TERMS = weakref.WeakKeyDictionary()  # BN module -> {dtype: Terms}


def k3_terms(bn, compute_dtype=None):
    """``bn_terms`` prepared for K3 (``ops.bn_epilogue.Terms``) once per
    BN module and compute dtype, while they are the module's own tensors
    where they were; terms that ``bn_terms`` casts afresh are prepared
    at each call."""
    prepared = _K3_TERMS.get(bn)
    if prepared is None:
        prepared = _K3_TERMS[bn] = {}
    t = prepared.get(compute_dtype)
    if t is None or not t.holds(bn.mean, bn.var, bn.scale, bn.bias):
        t = prepared[compute_dtype] = Terms(*bn_terms(bn, compute_dtype))
    return t


def bn_relu(x, bn, compute_dtype=None, residual=None, shortcut=None):
    """Eval-mode ``relu(bn(x) [+ residual])``, or with ``shortcut = (s,
    bn')`` ``relu(bn(x) + bn'(s))``: one K3 pass on the card
    (``ops.bn_epilogue``), the eager chain to the bit elsewhere."""
    terms = k3_terms if x.is_cuda else bn_terms
    if shortcut is not None:
        s, sbn = shortcut
        shortcut = (s, terms(sbn, compute_dtype))
    return bn_epilogue(x, terms(bn, compute_dtype), residual, shortcut)


def batch_norm_train(x, bn, compute_dtype=None, group=None):
    """Train-mode BatchNorm over NHWC channels (resnet.py:48, train=True):
    (y, {"mean", "var"}), the new running statistics.

    The batch statistics are taken at the running statistics' dtype and
    normalise with the biased variance; the running variance blends in
    the unbiased one with ``BN_MOMENTUM``, as torch tracks it. ``bn`` is
    not changed.

    With a data ``group`` (``x`` one rank's equal share of the batch) the
    statistics are the global batch's, as ``jnp.mean`` of a batch-sharded
    array reduces across devices: the ranks' means averaged (the global
    mean, since the shares are equal), then the ranks' mean squared
    deviations from it averaged (the global biased variance); n counts
    the global batch. The averages round in another order than JAX's one
    global sum, an ulp apart; in exchange the path without a group is the
    one-device computation unchanged, and a group of one rank computes
    it to the bit. The trunk takes no gradient in either model family
    (``training.common.trainable_parameters``), so these collectives need
    no backward and have none.
    """
    scale, bias = bn.scale, bn.bias
    if compute_dtype is not None:
        scale, bias = scale.to(compute_dtype), bias.to(compute_dtype)
    xs = x.to(bn.mean.dtype)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    mean = _mean_over_ranks(xs.mean(dim=(0, 1, 2)), group)
    var = _mean_over_ranks((xs - mean).square().mean(dim=(0, 1, 2)), group)
    if group is not None:
        n *= dist.get_world_size(group)
    unbiased = var * (n / max(n - 1, 1))
    stats = {"mean": (1 - BN_MOMENTUM) * bn.mean + BN_MOMENTUM * mean,
             "var": (1 - BN_MOMENTUM) * bn.var + BN_MOMENTUM * unbiased}
    inv = torch.rsqrt(var + BN_EPS) * scale
    y = (x - mean) * inv + bias
    return y.to(x.dtype), stats


def _mean_over_ranks(x, group):
    """``x`` averaged over the ranks of ``group`` (itself without one)."""
    if group is None:
        return x
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def _bn_relu(x, bn, compute_dtype, stats, group=None, residual=None,
             shortcut=None):
    """``bn_relu``'s forms in eval mode, when ``stats`` is None; else
    with train-mode BN (over the data ``group``'s global batch), the new
    running statistics recorded in ``stats`` under each module."""
    if stats is None:
        return bn_relu(x, bn, compute_dtype, residual, shortcut)
    y, stats[bn] = batch_norm_train(x, bn, compute_dtype, group)
    if shortcut is not None:
        s, sbn = shortcut
        residual, stats[sbn] = batch_norm_train(s, sbn, compute_dtype, group)
    if residual is not None:
        y = y + residual
    return y.relu()


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


def _nhwc_memory(x):
    """NHWC ``x`` with every stride a contiguous tensor has. cuDNN reads
    the layout from the strides, a size-1 dimension's too (a numpy
    ``img[None]`` has stride 0 there), and keeps channels_last from such
    an input on: every activation of the trunk is then NHWC in memory, as
    K3 takes them."""
    _, h, w, c = x.shape
    if x.stride() == (h * w * c, w * c, c, 1):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _bottleneck(block, x, compute_dtype, conv=conv2d, stats=None,
                group=None):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with projection shortcut."""
    out = _bn_relu(conv(x, _w(block.conv1, compute_dtype)),
                   block.bn1, compute_dtype, stats, group)
    out = _bn_relu(conv(out, _w(block.conv2, compute_dtype),
                        stride=block.stride, padding=1),
                   block.bn2, compute_dtype, stats, group)
    out = conv(out, _w(block.conv3, compute_dtype))
    if block.downsample is None:
        return _bn_relu(out, block.bn3, compute_dtype, stats, group,
                        residual=x)
    s = conv(x, _w(block.downsample.conv, compute_dtype), stride=block.stride)
    return _bn_relu(out, block.bn3, compute_dtype, stats, group,
                    shortcut=(s, block.downsample.bn))


def resnet_forward(resnet, x, compute_dtype=None, conv=None, train=False,
                   group=None):
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
    ``ops.quant.int8_conv`` plugs in there. In train mode a data
    ``group`` takes the BN statistics over the ranks' global batch
    (``batch_norm_train``).
    """
    if conv is None:
        conv = conv2d
    if compute_dtype is None:
        x = x.to(resnet.stem.conv.dtype)
    else:
        x = x.to(compute_dtype)
    x = _nhwc_memory(x)
    stats = {} if train else None
    out = conv(x, _w(resnet.stem.conv, compute_dtype), stride=2, padding=3)
    out = _bn_relu(out, resnet.stem.bn, compute_dtype, stats, group)
    out = max_pool(out, window=3, stride=2, padding=1)
    for blocks in resnet.layers:
        for block in blocks:
            out = _bottleneck(block, out, compute_dtype, conv, stats, group)
    return out if stats is None else (out, stats)
