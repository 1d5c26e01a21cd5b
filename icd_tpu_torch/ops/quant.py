"""The int8 convolution, and dynamic W8A8 quantization
(port of ``icd_tpu/ops/quant.py:25-56``).

``conv2d_int8`` is the int8 product that the JAX package leaves to XLA
(``lax.conv_general_dilated`` with an int32 result,
``icd_tpu/models/resnet_int8.py:174`` and ``ops/quant.py:48``). It is
not a Pallas kernel, and PyTorch has no int8 convolution on CUDA, so it
is built here as im2col plus ``torch._int_mm`` (cuBLASLt's int8 product
on the card, an exact int32 product on the CPU), one code path on both
devices:

- a 1x1 stride-1 convolution is a product over the (B*H*W, Cin) pixels;
- a 1x1 stride-2 one is a product over ``x[:, ::2, ::2]``;
- a kh x kw convolution is a product over the kh*kw shifted, strided
  slices of the zero-padded input, concatenated on the channel axis in
  (kh, kw, cin) order, so that HWIO weights reshape straight into the
  (kh*kw*Cin, Cout) operand. ``F.unfold`` takes no int8.

cuBLASLt's int8 product takes more than 16 rows and depths and widths
that are multiples of 8 (``int_mm`` pads what is short with zeros), and
is faster with the weights column-major than row-major on large
products (``chip_smoke.py``'s int8_conv phase times both layouts).
``gemm_layout`` stores the weights that way: still HWIO in shape and
values, (Cout, kh, kw, Cin) in memory.

The dynamic ``int8_conv`` (symmetric per-tensor activation scale,
per-output-channel weight scale, int32 sums, dequantized output) plugs
into ``models.resnet.resnet_forward(..., conv=int8_conv)``; the serving
path is the static one of ``models/resnet_int8.py``.
"""

import torch
import torch.nn.functional as F

_MIN_ROWS = 17  # cuBLASLt's int8 product takes more than 16 rows


def _ceil8(n):
    return -(-n // 8) * 8


def gemm_layout(w):
    """The same int8 values, column-major as a (K, N) operand: a (..., N)
    weight whose leading dims flatten to K is stored (N, ...)."""
    perm = (w.dim() - 1,) + tuple(range(w.dim() - 1))
    back = tuple(range(1, w.dim())) + (0,)
    return w.permute(perm).contiguous().permute(back)


def int_mm(a, b, n=None):
    """(M, K) int8 @ (K, N) int8 -> (M, n) int32, ``n`` defaulting to N.

    Rows are padded to 17, and K and N to multiples of 8, with zeros (a
    zero term adds nothing to a sum); ``a`` may come with its zero
    columns already added. The padding is sliced off the result.
    Weights on the serving path come padded (``pad_columns``), so only
    the activations' rows of a small batch are copied.
    """
    m, k = a.shape
    n = b.shape[1] if n is None else n
    kp, np_ = _ceil8(k), _ceil8(b.shape[1])
    if kp != k:
        a = F.pad(a, (0, kp - k))
    if (kp, np_) != tuple(b.shape):
        b = F.pad(b.t(), (0, kp - b.shape[0], 0, np_ - b.shape[1])).t()
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))
    return torch._int_mm(a, b)[:m, :n]


def pad_columns(w):
    """(K, N) int8 -> (K, N rounded up to 8), zero columns added,
    column-major (``gemm_layout``)."""
    k, n = w.shape
    return gemm_layout(F.pad(w, (0, _ceil8(n) - n)))


def div(a, b):
    """``a / b`` for a Python number ``b``, as one IEEE division on every
    device: ATen's CUDA kernel turns a division by a CPU scalar into a
    multiplication by its reciprocal, which rounds differently from the
    CPU and from the JAX package (one bit, now and then)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _pairs(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_int8(xq, wq, stride=1, padding=0):
    """(B, H, W, Cin) int8 x HWIO int8 -> (B, Ho, Wo, Cout) int32.

    ``padding`` is an int or ((top, bottom), (left, right)) as in
    ``lax.conv_general_dilated``; the input is padded with zeros.
    """
    sh, sw = _pairs(stride)
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    (pt, pb), (pl, pr) = padding
    b, h, w, cin = xq.shape
    kh, kw, _, cout = wq.shape
    if pt or pb or pl or pr:
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
    ho = (h + pt + pb - kh) // sh + 1
    wo = (w + pl + pr - kw) // sw + 1
    k = kh * kw * cin
    if kh == kw == 1:
        cols = xq[:, :sh * (ho - 1) + 1:sh, :sw * (wo - 1) + 1:sw]
    else:
        parts = [xq[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
                 for i in range(kh) for j in range(kw)]
        if k % 8:  # the stem's 7*7*3 = 147: zero columns to 152, one copy
            parts.append(xq.new_zeros(b, ho, wo, _ceil8(k) - k))
        cols = torch.cat(parts, dim=-1)
    acc = int_mm(cols.reshape(b * ho * wo, -1), wq.reshape(k, cout))
    return acc.reshape(b, ho, wo, cout)


def _quantize_per_tensor(x):
    scale = div(x.abs().max(), 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_weight_per_channel(w):
    # w: HWIO; scale per output channel.
    scale = div(w.abs().amax(dim=(0, 1, 2)), 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return gemm_layout(q), scale


def int8_conv(x, w, stride=1, padding=0):
    """Drop-in for ``models.resnet.conv2d`` (NHWC x OIHW) with W8A8
    dynamic quantization (quant.py:40)."""
    xq, xs = _quantize_per_tensor(x)
    wq, ws = _quantize_weight_per_channel(w.permute(2, 3, 1, 0))
    acc = conv2d_int8(xq, wq, stride=stride, padding=padding)
    # Dequantize into the surrounding compute dtype (bf16 on the serving
    # path) so inter-layer tensors do not widen to f32.
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    return (acc.float() * (xs * ws)).to(out_dtype)
