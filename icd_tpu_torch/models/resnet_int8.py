"""Static-calibration W8A8 int8 ResNet backbone, eval mode
(port of ``icd_tpu/models/resnet_int8.py``).

1. **Calibrate once** (``calibrate_act_maxes``): run a few batches
   through the float backbone and record the abs-max of every conv
   input (104 sites for ResNet-101, in call order: stem, then per block
   conv1, conv2, conv3, downsample).
2. **Quantize once** (``quantize_resnet``): weights to per-output-channel
   int8, and the eval-mode BatchNorm after each conv folded into the
   dequantization affine, so each site is ``{wq, scale, bias, inv_in}``
   with ``out = conv_int8(q(x)) * scale + bias``. Computed in numpy
   exactly as the JAX package does, so the same float weights and
   ``act_maxes`` give the same tree, bit for bit.
3. **Serve** (``resnet_int8_forward``): int8 convolutions
   (``ops.quant.conv2d_int8``) with an affine -> (residual add) -> relu
   -> requantize chain between them, one pass of kernel K4 on the card
   (``ops.int8_epilogue``), the eager chain to the bit elsewhere.

The tree is a dict of tensors shaped as the JAX tree: ``wq`` HWIO int8
(stored column-major for cuBLASLt, ``ops.quant.gemm_layout``), ``scale``
and ``bias`` (Cout,) f32, ``inv_in`` a 0-d f32 tensor. Every value
before the last cast is an integer or the result of one IEEE f32
operation taken in the JAX package's order (``acc * scale + bias`` as
two operations, ``requant`` multiplies by ``inv_in``, ``1 / inv_in`` in
f32, rounding half to even), so the forward equals the JAX package's
bit for bit. Calibration does not: the float convolutions differ in
their last bits between XLA and cuDNN or MKL.
"""

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.image import normalize_imagenet
from ..ops.int8_epilogue import Terms, dequant, int8_epilogue, requant
from ..ops.quant import conv2d_int8, gemm_layout
from .resnet import BN_EPS, conv2d, max_pool, resnet_forward

N_SITES_RESNET101 = 104  # 1 stem + 33*3 bottleneck + 4 downsample


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

@torch.no_grad()
def collect_conv_input_maxes(resnet, imgs, compute_dtype=torch.bfloat16):
    """One forward pass; returns (n_sites,) f32 abs-max of each conv
    input, in call order (resnet_int8.py:48). ``imgs`` may be uint8
    (ImageNet-normalized here) or already-normalized floats."""
    x = normalize_imagenet(imgs) if imgs.dtype == torch.uint8 else imgs
    maxes = []

    def recording_conv(x, w, stride=1, padding=0):
        maxes.append(x.float().abs().max())
        return conv2d(x, w, stride=stride, padding=padding)

    resnet_forward(resnet, x, compute_dtype=compute_dtype,
                   conv=recording_conv)
    return torch.stack(maxes)


def calibrate_act_maxes(resnet, batches, compute_dtype=torch.bfloat16):
    """Elementwise max of ``collect_conv_input_maxes`` over batches
    (resnet_int8.py:68), as a float32 numpy array.

    ``batches``: iterable of (B, H, W, 3) arrays or tensors (uint8 or
    float), moved to the backbone's device. A single array is one batch.
    """
    if hasattr(batches, "ndim"):
        batches = [batches]
    device = resnet.stem.conv.device
    maxes = None
    for b in batches:
        b = torch.as_tensor(b).to(device)
        v = collect_conv_input_maxes(resnet, b, compute_dtype)
        v = v.cpu().numpy().astype(np.float32)
        maxes = v if maxes is None else np.maximum(maxes, v)
    if maxes is None:
        raise ValueError("calibrate_act_maxes: no calibration batches")
    return maxes


# ---------------------------------------------------------------------------
# Build-time quantization (BN folded into the dequant affine)
# ---------------------------------------------------------------------------

def _np32(t):
    return t.detach().to("cpu", torch.float32).numpy()


def _quantize_site(w, bn, act_max, device):
    """``w`` OIHW (the port's layout); the arithmetic is resnet_int8.py:95
    on the HWIO weight."""
    act_max = max(float(act_max), 1e-8)
    s_in = act_max / 127.0
    w = _np32(w).transpose(2, 3, 1, 0)
    ws = np.maximum(np.max(np.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    inv_std = 1.0 / np.sqrt(_np32(bn.var) + BN_EPS)
    g = _np32(bn.scale) * inv_std
    return {
        "wq": gemm_layout(torch.from_numpy(wq).to(device)),
        "scale": torch.from_numpy(
            (s_in * ws * g).astype(np.float32)).to(device),
        "bias": torch.from_numpy(
            (_np32(bn.bias) - _np32(bn.mean) * g).astype(np.float32)
        ).to(device),
        "inv_in": torch.tensor(np.float32(1.0 / s_in), device=device),
    }


def quantize_resnet(resnet, act_maxes):
    """Float ``ResNet`` + calibrated maxes -> the int8 serving tree
    (resnet_int8.py:112), on the backbone's device."""
    act_maxes = np.asarray(act_maxes, np.float32)
    it = iter(act_maxes)
    device = resnet.stem.conv.device

    def take():
        v = next(it, None)
        if v is None:
            raise ValueError(
                "act_maxes has too few entries for this backbone "
                "(got {})".format(len(act_maxes)))
        return v

    def site(conv, bn):
        return _quantize_site(conv, bn, take(), device)

    q = {"stem": site(resnet.stem.conv, resnet.stem.bn), "layers": []}
    for blocks in resnet.layers:
        qblocks = []
        for block in blocks:
            qb = {"conv1": site(block.conv1, block.bn1),
                  "conv2": site(block.conv2, block.bn2),
                  "conv3": site(block.conv3, block.bn3)}
            if block.downsample is not None:
                qb["downsample"] = site(block.downsample.conv,
                                        block.downsample.bn)
            qblocks.append(qb)
        q["layers"].append(qblocks)
    leftover = len(list(it))
    if leftover:
        raise ValueError(
            "act_maxes has {} extra entries for this backbone".format(
                leftover))
    return q


def tree_to(tree, device):
    """The quantized tree (nested dicts and lists of tensors) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Serving forward
# ---------------------------------------------------------------------------

def _conv_affine(xi, site, stride=1, padding=0):
    """s8 input -> int8 conv (int32 sums) -> folded BN affine, f32 out."""
    acc = conv2d_int8(xi, site["wq"], stride=stride, padding=padding)
    return dequant(acc, site["scale"], site["bias"])


def _qconv(x, site, stride=1, padding=0):
    """quantize(x) -> int8 conv -> folded BN affine, f32 out."""
    return _conv_affine(requant(x, site["inv_in"]), site,
                        stride=stride, padding=padding)


def _stem_s2d(x, site):
    """Space-to-depth stem, bit-exact with the stock 7x7/2 stem
    (resnet_int8.py:187): 2x2 pixel blocks become channels (3 -> 12) and
    the kernel, zero-padded to 8x8 at the top and left, is regrouped the
    same way into a (4, 4, 12, 64) stride-1 conv with padding (2, 1). The
    same 147 taps plus zero taps: the same int32 sums, returned."""
    xi = requant(x, site["inv_in"])  # (B, H, W, 3) s8
    b, hh, ww, c = xi.shape
    x2 = xi.reshape(b, hh // 2, 2, ww // 2, 2, c)
    x2 = x2.permute(0, 1, 3, 2, 4, 5).reshape(b, hh // 2, ww // 2, 4 * c)
    w8 = torch.nn.functional.pad(site["wq"], (0, 0, 0, 0, 1, 0, 1, 0))
    kh, kw, _, co = w8.shape
    w4 = w8.reshape(kh // 2, 2, kw // 2, 2, c, co)
    w4 = w4.permute(0, 2, 1, 3, 4, 5).reshape(kh // 2, kw // 2, 4 * c, co)
    return conv2d_int8(x2, w4, stride=1, padding=((2, 1), (2, 1)))


def epilogue_terms(site, inv_next=None, in_inv=None, downsample=None):
    """A site's epilogue terms (``ops.int8_epilogue``): its scale and
    bias, the next site's ``inv_next`` (None: float output), and the
    identity shortcut's ``in_inv`` or the ``downsample`` site's scale
    and bias."""
    ds = downsample or {}
    return (site["scale"], site["bias"], inv_next, in_inv, ds.get("scale"),
            ds.get("bias"))


_K4_TERMS = WeakIdKeyDictionary()  # a site's scale tensor -> its Terms


def k4_terms(site, inv_next=None, in_inv=None, downsample=None):
    """``epilogue_terms`` prepared for K4 (``ops.int8_epilogue.Terms``)
    once per site, kept outside the tree, while they are the tensors
    they were."""
    args = epilogue_terms(site, inv_next, in_inv, downsample)
    t = _K4_TERMS.get(site["scale"])
    if t is None or not t.holds(*args):
        t = _K4_TERMS[site["scale"]] = Terms(*args)
    return t


def _epilogue(acc, site, inv_next=None, in_inv=None, downsample=None,
              other=None, out_dtype=None):
    """One int8 convolution's epilogue (``ops.int8_epilogue``): K4 with
    the site's prepared terms on the card, the eager chain elsewhere."""
    terms = k4_terms if acc.is_cuda else epilogue_terms
    return int8_epilogue(acc, terms(site, inv_next, in_inv, downsample),
                         other, out_dtype)


@torch.no_grad()
def resnet_int8_forward(qparams, x, out_dtype=torch.bfloat16,
                        residual="int8", use_s2d_stem=False):
    """(B, H, W, 3) normalized float -> stride-32 NHWC features
    (resnet_int8.py:230), inference only.

    residual="int8" (default) keeps the trunk int8-resident: each block
    output is quantized once with the next block's conv1 input scale,
    and the shortcut dequantizes from that same s8 tensor; the quantize
    commutes with the stem max-pool, which therefore runs on s8. Every
    convolution's epilogue (affine, residual add, relu, requantize: 100
    for ResNet-101) is one ``_epilogue``, K4 on the card.
    residual="bf16" keeps block outputs in ``out_dtype``.
    """
    if residual not in ("int8", "bf16"):
        raise ValueError("residual must be 'int8' or 'bf16'")
    stem = qparams["stem"]
    if (use_s2d_stem and tuple(stem["wq"].shape[:2]) == (7, 7)
            and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
        acc = _stem_s2d(x, stem)
    else:
        acc = conv2d_int8(requant(x, stem["inv_in"]), stem["wq"], stride=2,
                          padding=3)

    if residual == "bf16":
        stem_out = torch.relu(dequant(acc, stem["scale"], stem["bias"]))
        out = max_pool(stem_out.to(out_dtype), window=3, stride=2, padding=1)
        for stage, blocks in enumerate(qparams["layers"]):
            for b, qb in enumerate(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                h = torch.relu(_qconv(out, qb["conv1"]))
                h = torch.relu(
                    _qconv(h, qb["conv2"], stride=stride, padding=1))
                h = _qconv(h, qb["conv3"])
                if "downsample" in qb:
                    shortcut = _qconv(out, qb["downsample"], stride=stride)
                else:
                    shortcut = out.float()
                out = torch.relu(h + shortcut).to(out_dtype)
        return out

    # int8-resident trunk, one block of lookahead: each block output is
    # quantized with the NEXT conv1's calibrated input scale.
    all_blocks = [(qb, 2 if (stage > 0 and b == 0) else 1)
                  for stage, blocks in enumerate(qparams["layers"])
                  for b, qb in enumerate(blocks)]
    # round and clip are monotone, so the quantize commutes with the
    # max pool: pooling runs on s8.
    q = max_pool(_epilogue(acc, stem, all_blocks[0][0]["conv1"]["inv_in"]),
                 window=3, stride=2, padding=1)
    for i, (qb, stride) in enumerate(all_blocks):
        c1, c2, c3 = qb["conv1"], qb["conv2"], qb["conv3"]
        h = _epilogue(conv2d_int8(q, c1["wq"]), c1, c2["inv_in"])
        h = _epilogue(conv2d_int8(h, c2["wq"], stride=stride, padding=1), c2,
                      c3["inv_in"])
        inv_next = (None if i + 1 == len(all_blocks)
                    else all_blocks[i + 1][0]["conv1"]["inv_in"])
        acc = conv2d_int8(h, c3["wq"])
        if "downsample" in qb:
            ds = qb["downsample"]
            q = _epilogue(acc, c3, inv_next, downsample=ds,
                          other=conv2d_int8(q, ds["wq"], stride=stride),
                          out_dtype=out_dtype)
        else:
            # q was quantized with this block's conv1 input scale.
            q = _epilogue(acc, c3, inv_next, in_inv=c1["inv_in"], other=q,
                          out_dtype=out_dtype)
    return q
