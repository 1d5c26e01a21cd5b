"""K4: the epilogue after each int8 convolution of the static-int8
ResNet trunk (``models/resnet_int8.py``) in one pass.

It replaces no TPU kernel: the JAX package leaves this chain to XLA,
which fuses it with its neighbours, and the eager port ran it as a
chain of ATen passes over f32 (``int8_epilogue_reference`` below). For
a convolution's int32 sums ``acc``, contiguous (..., C), and one site's
terms ``(scale, bias, inv_next, in_inv, ds_scale, ds_bias)``
(``Terms``) it computes::

    y = f32(acc) * scale + bias                      stem, conv1, conv2
    y = y + f32(q) * (1 / in_inv)                    conv3, identity shortcut q
    y = y + (f32(ds) * ds_scale + ds_bias)           conv3, downsample sums ds
    requant(relu(y), inv_next)                       s8 for the next site
    relu(y).to(out_dtype)                            the last block (inv_next None)

with ``requant(x, inv) = int8(clamp(round(x * inv), -127, 127))``. The
kernel does the same f32 operations in the same order at the same
roundings, so its output equals the chain's to the bit: the shortcut's
scale ``1.0 / in_inv`` is the value ATen computes, prepared once
(``Terms.in_scale``), never divided anew in the kernel.

On the card this is ``csrc/int8_epilogue.cu``: bound by bytes (each
int32 sum read once, the shortcut once, the output written once; at
batch 64 the trunk's 100 sites move 5.58 GB, 1.67 ms at 3.35 TB/s,
``bound_ms``); the source says how its design follows.
``int8_epilogue`` launches it for CUDA tensors and raises on what it
does not take; for CPU (and meta) tensors it runs the plain version. K4
has no backward: the int8 trunk is frozen, and it raises where autograd
would record it.

A launch costs the host more than the card at the trunk's small sites,
so a site's terms are checked once: ``Terms`` holds them with their
pointers in a C record that every launch passes by address
(``models.resnet_int8`` keeps one per site). A launch then checks only
the activations, allocates the output and calls the library.
"""

import ctypes
import functools

import torch

from .. import kernels
from ..utils.benchmarking import HBM_BYTES_PER_S

_OUT_CODES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_VEC = 16  # channels a thread in the kernel's vector variant
_ALIGN = 16  # bytes of a vector


def dequant(acc, scale, bias):
    """A site's int32 sums -> its folded BN affine, f32."""
    return acc.float() * scale + bias


def requant(x, inv):
    """float -> symmetric s8 with a site's static input scale."""
    return torch.clamp(torch.round(x.float() * inv), -127,
                       127).to(torch.int8)


def int8_epilogue_reference(acc, terms, other=None, out_dtype=None):
    """Plain PyTorch version of K4: the eager chain it replaces."""
    scale, bias, inv_next, in_inv, ds_scale, ds_bias = terms
    y = dequant(acc, scale, bias)
    if in_inv is not None:
        y = y + other.float() * (1.0 / in_inv)
    elif ds_scale is not None:
        y = y + dequant(other, ds_scale, ds_bias)
    y = torch.relu(y)
    if inv_next is not None:
        return requant(y, inv_next)
    return y.to(out_dtype)


def int8_epilogue(acc, terms, other=None, out_dtype=None):
    """The epilogue of one int8 convolution: s8 requantized with
    ``inv_next``, or with ``inv_next`` None ``out_dtype`` (float32 or
    bfloat16). ``terms`` is a site's ``(scale, bias, inv_next, in_inv,
    ds_scale, ds_bias)``, or the same prepared once as ``Terms``.
    ``other`` is the identity shortcut's s8 input, quantized with
    ``in_inv``, where ``in_inv`` is given, the downsample's int32 sums
    where ``ds_scale`` and ``ds_bias`` are.

    CUDA tensors launch K4 or raise; others (the CPU's, the meta
    device's) take the plain version. ``int8_epilogue.launches`` counts
    the kernel's launches.
    """
    if not acc.is_cuda:
        return int8_epilogue_reference(acc, terms, other, out_dtype)
    return _launch(acc, terms, other, out_dtype)


int8_epilogue.launches = 0


class _HostTerms(ctypes.Structure):
    """``HostTerms`` of csrc/int8_epilogue.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "scale", "bias", "inv_next", "in_scale", "ds_scale", "ds_bias")]


class Terms(tuple):
    """One site's terms ``(scale, bias, inv_next, in_inv, ds_scale,
    ds_bias)``, checked once for K4: float32 tensors on one device,
    scale and bias (and ds_scale and ds_bias) (C,) and contiguous,
    inv_next and in_inv single values, each absent one None. It stays
    the tuple of the terms, which the plain version takes as it is, and
    adds what a launch passes: ``in_scale = 1.0 / in_inv``, computed
    here once as the eager chain computes it, and a C record
    (``HostTerms``) of the pointers to scale, bias, inv_next, in_scale,
    ds_scale and ds_bias at ``address``. The record reads those terms'
    memory at each launch, so values written into them in place need no
    new ``Terms``; a term moved does (``holds``), and so does a new
    in_inv value, as in_scale is computed once."""

    def __new__(cls, scale, bias, inv_next=None, in_inv=None,
                ds_scale=None, ds_bias=None):
        self = super().__new__(cls, (scale, bias, inv_next, in_inv,
                                     ds_scale, ds_bias))
        c = scale.shape[0] if scale.dim() == 1 else -1
        if (ds_scale is None) != (ds_bias is None):
            raise ValueError("K4: the downsample needs ds_scale and ds_bias")
        if in_inv is not None and ds_scale is not None:
            raise ValueError("K4 takes an identity shortcut or a "
                             "downsample, not both")
        for i, t in enumerate(self):
            if t is None:
                continue
            if t.dtype != torch.float32:
                raise TypeError("K4 takes float32 terms, got {}".format(
                    t.dtype))
            if t.device != scale.device:
                raise ValueError("K4: the terms are on {} and {}".format(
                    scale.device, t.device))
            if i in (2, 3):
                if t.numel() != 1:
                    raise ValueError("K4: inv_next and in_inv are single "
                                     "values, got shape {}".format(
                                         tuple(t.shape)))
            elif t.shape != (c,) or not t.is_contiguous():
                raise ValueError("K4: a channel term has shape {}, expected "
                                 "({},), contiguous".format(tuple(t.shape),
                                                            c))
        self.channels = c
        self.device_index = scale.get_device()
        self.residual = 1 if in_inv is not None else (
            2 if ds_scale is not None else 0)
        self.requires_grad = any(t is not None and t.requires_grad
                                 for t in self)
        self.ptrs = tuple(0 if t is None else t.data_ptr() for t in self)
        self.in_scale = None
        if in_inv is not None:
            with torch.no_grad():
                self.in_scale = 1.0 / in_inv
        launch = list(self[:3]) + [self.in_scale] + list(self[4:])
        # Only the channel terms are read in 16-byte words.
        self.aligned = all(t is None or t.data_ptr() % _ALIGN == 0
                           for t in (scale, bias, ds_scale, ds_bias))
        self.record = _HostTerms(*(None if t is None else t.data_ptr()
                                   for t in launch))
        self.address = ctypes.addressof(self.record)
        return self

    def holds(self, *terms):
        """Whether this record describes these terms: the same memory."""
        return tuple(0 if t is None else t.data_ptr()
                     for t in terms) == self.ptrs


@functools.cache
def _kernel():
    """K4's entry point in its library, loaded and typed once."""
    fn = kernels.load("int8_epilogue").icd_int8_epilogue
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(acc, terms, other=None, out_dtype=None):
    """Launch K4 on the current stream; returns the output."""
    t = terms if isinstance(terms, Terms) else Terms(*terms)
    if acc.dtype != torch.int32:
        raise TypeError("K4 takes int32 sums, got {}".format(acc.dtype))
    if acc.dim() < 1 or not acc.is_contiguous():
        raise ValueError("K4 takes contiguous (..., C) sums (NHWC)")
    c = acc.shape[-1]
    if t.channels != c:
        raise ValueError("K4: a channel term has shape ({},), expected "
                         "({},), contiguous".format(t.channels, c))
    want = (None, torch.int8, torch.int32)[t.residual]
    if (other is None) != (want is None) or (other is not None and (
            other.shape != acc.shape or other.dtype != want
            or not other.is_contiguous())):
        raise ValueError("K4: these terms take {}".format(
            "no shortcut input" if want is None else
            "a contiguous {} {} shortcut input".format(tuple(acc.shape),
                                                       want)))
    dtype = torch.int8 if t[2] is not None else out_dtype
    code = _OUT_CODES.get(dtype)
    if code is None or (t[2] is None and dtype == torch.int8):
        raise TypeError("K4 writes float32 or bfloat16 without inv_next, "
                        "got {}".format(dtype))
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("K4 has no backward: run the int8 trunk under "
                           "torch.no_grad() or inference_mode()")
    if not acc.is_cuda:
        raise ValueError("K4 runs on CUDA tensors, got {}".format(
            acc.device))
    device = acc.get_device()
    if ((other is not None and other.get_device() != device)
            or t.device_index != device):
        raise ValueError("K4: every operand must be on {}".format(
            acc.device))
    out = torch.empty_like(acc, dtype=dtype)
    ptrs = (acc.data_ptr(), 0 if other is None else other.data_ptr(),
            out.data_ptr())
    vec = _VEC
    if c % vec or (ptrs[0] | ptrs[1] | ptrs[2]) % _ALIGN or not t.aligned:
        vec = 1
    # The raw current stream, as Triton's launcher reads it: a Stream
    # object costs the host more than the launch.
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = _kernel()(ptrs[0], ptrs[1] or None, ptrs[2], t.address,
                    acc.numel(), c, t.residual, code, vec, device, stream)
    if err != 0:
        raise RuntimeError("K4 launch failed: CUDA error {}".format(err))
    int8_epilogue.launches += 1
    return out


def bound_ms(sites, out_bytes=2):
    """Least time for K4's launches at ``sites`` ((NHWC shape, residual,
    s8 output) each, ``testing.int8_epilogue_sites``) on an H100: each
    int32 sum read once (4 B), the s8 shortcut (1 B) or the downsample's
    int32 sums (4 B) once, the output written once (1 B, or
    ``out_bytes`` at the last block: bf16 on the serving trunk), and
    every site's f32 terms once, at 3.35 TB/s. The arithmetic, a few
    operations an element, is far below the card's peak: bound by
    bytes."""
    nbytes = 0
    for shape, residual, s8 in sites:
        n = 1
        for d in shape:
            n *= d
        nbytes += n * (4 + (0, 1, 4)[residual] + (1 if s8 else out_bytes))
        nbytes += shape[-1] * 4 * (4 if residual == 2 else 2)
    return nbytes / HBM_BYTES_PER_S * 1e3
