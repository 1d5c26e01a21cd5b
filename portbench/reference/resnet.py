"""ResNet-101 (He et al. 2016, arXiv:1512.03385) as torchvision builds
it: a 7x7 stem, 3x3 max pool, bottleneck stages of (3, 4, 23, 3)
blocks with the stride on the 3x3 convolution and a 1x1 projection
shortcut where the shape changes. NCHW, float32.

Weights are read from a dict by the names ``<prefix>stem.conv``,
``<prefix>stem.bn.{scale,bias,mean,var}``,
``<prefix>layers.<stage>.<block>.conv1`` ... ``downsample.bn.var``.
"""

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.1  # new running statistic = 0.9 old + 0.1 batch
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def normalize(imgs):
    """uint8 NHWC images -> ImageNet-normalised float32 NCHW."""
    x = imgs.float() / 255.0
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


class BatchNorm:
    """BN over NCHW channels. ``mode`` is "eval" (running statistics),
    "train" (batch statistics; the new running statistics are recorded
    in ``self.new``) or "estimate" (the running statistics are set to
    the batch's, unbiased variance, then used as in eval)."""

    def __init__(self, w, mode):
        self.w, self.mode, self.new = w, mode, {}

    def __call__(self, x, name):
        w = self.w
        scale, bias = w[name + ".scale"], w[name + ".bias"]
        if self.mode == "train":
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            n = x.numel() // x.shape[1]
            self.new[name + ".mean"] = ((1 - MOMENTUM) * w[name + ".mean"]
                                        + MOMENTUM * mean)
            self.new[name + ".var"] = ((1 - MOMENTUM) * w[name + ".var"]
                                       + MOMENTUM * var * n / (n - 1))
        else:
            if self.mode == "estimate":
                w[name + ".mean"].copy_(x.mean(dim=(0, 2, 3)))
                w[name + ".var"].copy_(x.var(dim=(0, 2, 3)))
            mean, var = w[name + ".mean"], w[name + ".var"]
        inv = scale / torch.sqrt(var + EPS)
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + bias[:, None, None]


def _conv(x, w, stride=1, padding=0):
    return F.conv2d(x, w, stride=stride, padding=padding)


def forward(w, x, depths, prefix="resnet.", mode="eval", conv=_conv):
    """NCHW float32 -> the last stage's NCHW features, and the BN's new
    running statistics (empty unless ``mode`` is "train"). ``conv`` may
    replace every convolution with a lower-precision one (the
    control)."""
    bn = BatchNorm(w, mode)
    p = prefix
    x = conv(x, w[p + "stem.conv"], stride=2, padding=3)
    x = F.relu(bn(x, p + "stem.bn"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage, depth in enumerate(depths):
        for block in range(depth):
            q = "{}layers.{}.{}.".format(p, stage, block)
            stride = 2 if stage > 0 and block == 0 else 1
            out = F.relu(bn(conv(x, w[q + "conv1"]), q + "bn1"))
            out = F.relu(bn(conv(out, w[q + "conv2"], stride=stride,
                                 padding=1), q + "bn2"))
            out = bn(conv(out, w[q + "conv3"]), q + "bn3")
            if q + "downsample.conv" in w:
                x = bn(conv(x, w[q + "downsample.conv"], stride=stride),
                       q + "downsample.bn")
            x = F.relu(out + x)
    return x, bn.new


@torch.no_grad()
def estimate_bn(w, imgs, depths, prefix="resnet."):
    """Set every BN's running statistics to those of its input over
    ``imgs`` (uint8 NHWC), layer by layer. A He-initialised ResNet-101
    with identity BN doubles its activations' variance at every block;
    statistics estimated on the images keep them at a trained
    encoder's scale."""
    forward(w, normalize(imgs), depths, prefix, mode="estimate")


def grid(w, imgs, depths, size, prefix="resnet.", mode="eval"):
    """uint8 NHWC images -> the (B, size * size, D) attention grid
    (adaptive average pool to size x size), and the new BN statistics
    in train mode."""
    feats, new = forward(w, normalize(imgs), depths, prefix, mode)
    g = F.adaptive_avg_pool2d(feats, size)
    return g.flatten(2).transpose(1, 2), new


def pooled(w, imgs, depths, prefix="resnet.", conv=_conv):
    """uint8 NHWC images -> (B, D) globally pooled features (eval)."""
    feats, _ = forward(w, normalize(imgs), depths, prefix, conv=conv)
    return feats.mean(dim=(2, 3))
