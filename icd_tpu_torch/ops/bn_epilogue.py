"""K3: the eval-mode batch norm of the float ResNet trunk, with its ReLU
and residual add, in one pass.

It replaces no TPU kernel: the JAX package leaves BN to XLA, which fuses
it with its neighbours, and the eager port ran it as a chain of ATen
passes (``affine`` below, then ``relu`` and a residual add). For a
contiguous NHWC activation ``x`` and one BN's ``terms`` ``(mean, var,
scale, bias, eps)`` (``models.resnet.bn_terms``) it computes one of three
forms::

    relu(bn(x))                 the stem, bn1, bn2
    relu(bn(x) + residual)      bn3 with an identity shortcut
    relu(bn(x) + bn'(s))        bn3 with a downsample, shortcut=(s, terms')

where ``bn(x) = ((x - mean) * inv + bias).to(x.dtype)`` with ``inv =
rsqrt(var + eps) * scale``, in PyTorch's promoted types. The kernel does
the same operations in the same order at the same roundings, so its
output equals the chain's to the bit: inv is computed in the kernel
with the rsqrt ATen calls, each step is an f32 operation without FMA
contraction, rounded to bf16 where PyTorch's promotion makes that
step's result bf16 (f32 statistics under ``cast_keep_bn_stats`` keep
the steps f32; cast statistics make them bf16), the BN result is
rounded to ``x``'s dtype, a residual sum rounded again, then the ReLU
taken.

On the card this is ``csrc/bn_epilogue.cu``: bound by bytes (each
activation read once and the output written once, in 16-byte words; at
batch 64 the trunk's 100 sites move 4.9 GB in bf16, 1.47 ms at 3.35
TB/s, ``bound_ms``); the source says how its design follows.
``bn_epilogue`` launches it for CUDA tensors and raises on what it does
not take; for CPU (and meta) tensors it runs the plain version,
``bn_epilogue_reference``. K3 has no backward: the trunk it serves is
frozen (``training.common``), and it raises where autograd would record
it.

A launch costs the host more than the card at the trunk's small sites,
so the terms are checked once: ``Terms`` holds them with their pointers,
flags and eps in a C record that every launch passes by address, and
``models.resnet`` keeps one per BN module and compute dtype. A launch
then checks only the activations, allocates the output and calls the
library.
"""

import ctypes
import functools

import torch

from .. import kernels
from ..utils.benchmarking import HBM_BYTES_PER_S

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements of a 16-byte vector
# A BN's flags (csrc/bn_epilogue.cu): mean, var, scale, bias stored in
# bf16; inv, the subtract, the multiply and the add rounding to bf16.
_MEAN_BF16, _VAR_BF16, _SCALE_BF16, _BIAS_BF16 = 1, 2, 4, 8
_INV_BF16, _SUB_BF16, _MUL_BF16, _ADD_BF16 = 16, 32, 64, 128
_ALIGN = 16  # bytes of a vector


def affine(x, mean, var, scale, bias, eps):
    """Eval-mode BN of ``x`` over its last dimension from the per-channel
    terms: ``(x - mean) * inv + bias`` with ``inv = rsqrt(var + eps) *
    scale``, in PyTorch's promoted types, rounded to ``x``'s dtype."""
    inv = torch.rsqrt(var + eps) * scale
    return ((x - mean) * inv + bias).to(x.dtype)


def bn_epilogue_reference(x, terms, residual=None, shortcut=None):
    """Plain PyTorch version of K3: the eager chain it replaces."""
    y = affine(x, *terms)
    if shortcut is not None:
        s, terms2 = shortcut
        residual = affine(s, *terms2)
    if residual is not None:
        y = y + residual
    return y.relu()


def bn_epilogue(x, terms, residual=None, shortcut=None):
    """``relu(bn(x))``, ``relu(bn(x) + residual)`` or, with ``shortcut=(s,
    terms')``, ``relu(bn(x) + bn'(s))``, in ``x``'s dtype. ``terms`` (and
    ``terms'``) are a BN's ``(mean, var, scale, bias, eps)``, or the same
    prepared once as ``Terms``.

    CUDA tensors launch K3 or raise; others (the CPU's, the meta
    device's) take the plain version. ``bn_epilogue.launches`` counts the
    kernel's launches.
    """
    if not x.is_cuda:
        return bn_epilogue_reference(x, terms, residual, shortcut)
    return _launch(x, terms, residual, shortcut)


bn_epilogue.launches = 0


@functools.cache
def _flags_of(x, mean, var, scale, bias):
    """A BN's flags for activations of dtype ``x``: which terms are bf16,
    and which steps of ``affine`` round to bf16 under PyTorch's
    promotion."""
    inv = torch.promote_types(var, scale)  # var + eps and rsqrt keep var's
    sub = torch.promote_types(x, mean)
    mul = torch.promote_types(sub, inv)
    add = torch.promote_types(mul, bias)
    bits = ((mean, _MEAN_BF16), (var, _VAR_BF16), (scale, _SCALE_BF16),
            (bias, _BIAS_BF16), (inv, _INV_BF16), (sub, _SUB_BF16),
            (mul, _MUL_BF16), (add, _ADD_BF16))
    return sum(bit for dtype, bit in bits if dtype == torch.bfloat16)


class _HostTerms(ctypes.Structure):
    """``HostTerms`` of csrc/bn_epilogue.cu."""
    _fields_ = [("mean", ctypes.c_void_p), ("var", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("flags", ctypes.c_int * 2), ("eps", ctypes.c_float)]


class Terms(tuple):
    """One BN's terms ``(mean, var, scale, bias, eps)``, checked once for
    K3: four contiguous (C,) float32 or bfloat16 tensors on one device.
    It stays the tuple of the terms, which the plain version takes as it
    is, and adds what a launch passes: a C record (``HostTerms``) of the
    four pointers, the flags for each activation dtype and eps, at
    ``address``. The record reads the terms' memory at each launch, so
    values written into the terms in place need no new ``Terms``; a term
    moved or recast does (``holds``)."""

    def __new__(cls, mean, var, scale, bias, eps):
        self = super().__new__(cls, (mean, var, scale, bias, eps))
        tensors = self[:4]
        c = mean.shape[0] if mean.dim() == 1 else -1
        for t in tensors:
            if t.dtype not in _DTYPE_CODES:
                raise TypeError("K3 takes float32 or bfloat16 BN terms, got "
                                "{}".format(t.dtype))
            if t.device != mean.device:
                raise ValueError("K3: the BN terms are on {} and {}".format(
                    mean.device, t.device))
            if t.shape != (c,) or not t.is_contiguous():
                raise ValueError("K3: a BN term has shape {}, expected "
                                 "({},), contiguous".format(tuple(t.shape),
                                                            c))
        self.channels = c
        self.device_index = mean.get_device()
        self.dtypes = tuple(t.dtype for t in tensors)
        self.ptrs = tuple(t.data_ptr() for t in tensors)
        self.aligned = all(p % _ALIGN == 0 for p in self.ptrs)
        flags = (ctypes.c_int * 2)(*(_flags_of(dt, *self.dtypes)
                                     for dt in _DTYPE_CODES))
        self.record = _HostTerms(*self.ptrs, flags, eps)
        self.address = ctypes.addressof(self.record)
        return self

    def holds(self, mean, var, scale, bias):
        """Whether this record describes these tensors: the same memory at
        the same dtypes."""
        p, d = self.ptrs, self.dtypes
        return (mean.data_ptr() == p[0] and var.data_ptr() == p[1]
                and scale.data_ptr() == p[2] and bias.data_ptr() == p[3]
                and mean.dtype == d[0] and var.dtype == d[1]
                and scale.dtype == d[2] and bias.dtype == d[3])


@functools.cache
def _kernel():
    """K3's entry point in its library, loaded and typed once."""
    fn = kernels.load("bn_epilogue").icd_bn_epilogue
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, terms, residual=None, shortcut=None):
    """Launch K3 on the current stream; returns the output."""
    if residual is not None and shortcut is not None:
        raise ValueError("K3 takes a residual or a shortcut, not both")
    other, terms2 = residual, None
    if shortcut is not None:
        other, terms2 = shortcut
    form = 0 if other is None else 1 if terms2 is None else 2
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError("K3 takes float32 or bfloat16 activations, got "
                        "{}".format(x.dtype))
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError("K3 takes a contiguous (..., C) activation (NHWC)")
    if other is not None and (other.shape != x.shape
                              or other.dtype != x.dtype
                              or not other.is_contiguous()):
        raise ValueError("K3: the residual or shortcut input must be a "
                         "contiguous {} {}".format(tuple(x.shape), x.dtype))
    t = terms if isinstance(terms, Terms) else Terms(*terms)
    t2 = terms2 if terms2 is None or isinstance(terms2, Terms) else Terms(
        *terms2)
    c = x.shape[-1]
    for u in (t, t2):
        if u is not None and u.channels != c:
            raise ValueError("K3: a BN term has shape ({},), expected "
                             "({},), contiguous".format(u.channels, c))
    if torch.is_grad_enabled() and any(
            u is not None and u.requires_grad
            for u in (x, other, *t[:4], *(t2 or (None,))[:4])):
        raise RuntimeError("K3 has no backward: run the eval-mode trunk "
                           "under torch.no_grad() or inference_mode()")
    if not x.is_cuda:
        raise ValueError("K3 runs on CUDA tensors, got {}".format(x.device))
    device = x.get_device()
    if ((other is not None and other.get_device() != device)
            or t.device_index != device
            or (t2 is not None and t2.device_index != device)):
        raise ValueError("K3: every operand must be on {}".format(x.device))
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), 0 if other is None else other.data_ptr(),
            out.data_ptr())
    vec = _VEC[x.dtype]
    if (c % vec or (ptrs[0] | ptrs[1] | ptrs[2]) % _ALIGN or not t.aligned
            or (t2 is not None and not t2.aligned)):
        vec = 1
    # The raw current stream, as Triton's launcher reads it: a Stream
    # object costs the host more than the launch.
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = _kernel()(ptrs[0], ptrs[1] or None, ptrs[2], t.address,
                    None if t2 is None else t2.address, x.numel(), c, code,
                    form, vec, device, stream)
    if err != 0:
        raise RuntimeError("K3 launch failed: CUDA error {}".format(err))
    bn_epilogue.launches += 1
    return out


def bound_ms(sites, elem_bytes=2, term_bytes=12):
    """Least time for K3's launches at ``sites`` ((NHWC shape, form) each,
    ``testing.bn_epilogue_sites``) on an H100: each activation read once
    (two in form 1 and 2) and the output written once, ``elem_bytes``
    each, and every BN's terms read once (``term_bytes`` a channel: f32
    mean and var, bf16 scale and bias on the bf16 serving trunk) at 3.35
    TB/s. The arithmetic, a few operations an element, is far below the
    card's peak: bound by bytes."""
    nbytes = 0
    for shape, form in sites:
        n = 1
        for d in shape:
            n *= d
        nbytes += n * elem_bytes * (2 if form == 0 else 3)
        nbytes += shape[-1] * term_bytes * (2 if form == 2 else 1)
    return nbytes / HBM_BYTES_PER_S * 1e3
