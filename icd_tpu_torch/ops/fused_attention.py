"""K1: fused soft-attention decode step plus gate.

Port of the TPU kernel ``icd_tpu/ops/fused_attention.py:45`` (``_kernel``,
launched by ``fused_attention_pallas`` at :84, ``pallas_call`` at :103;
its plain oracle is ``fused_attention_reference`` at :138). For each
decoder row::

    att_dec = h @ Wd^T + bd
    act     = relu(att_enc + att_dec)       (P, A), never stored by K1
    scores  = act @ wf + bf
    alpha   = softmax_P(scores)             f32
    ctx     = sigmoid(h @ Wg^T + bg) * sum_P(alpha * enc)

The only generalisation of the TPU kernel is what ``vmap`` did for the
beam loop: ``rows_per_image`` = k. ``h``, ``ctx`` and ``alpha`` have
B * k rows, ``enc`` (B, P, D) and ``att_enc`` (B, P, A) have B, and row r
reads image r // k. The TPU call is k = 1. The grid is never repeated k
times: it is the dominant read, and K1 reads it once per image.

Weights are in ``nn.Linear`` layout: ``wd`` (A, H), ``wg`` (D, H);
``wf`` (A,), ``bf`` (1,).

On the card this is ``csrc/fused_attention.cu``: bound by bytes, about
20 us at the serving shapes in bf16 (enc 51 MB + att_enc 13 MB read
once at 3.35 TB/s); the source says how its design follows from that.
``fused_attention`` launches it for CUDA tensors and raises on what it
does not take; for CPU tensors it runs ``fused_attention_reference``.
"""

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS_PER_IMAGE = 8
_MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100


def fused_attention_reference(enc, att_enc, h, wd, bd, wf, bf, wg, bg,
                              rows_per_image=1):
    """Plain PyTorch version of K1 (fused_attention.py:138-146).

    The softmax is taken in f32, as in the TPU kernel's oracle. With
    bf16 inputs this differs from ``soft_attention``, which rounds the
    scores to bf16 first (attention.py:106-108).
    """
    b, p, d = enc.shape
    k = rows_per_image
    att_dec = F.linear(h, wd, bd).view(b, k, 1, -1)
    act = torch.relu(att_enc[:, None] + att_dec)  # (B, k, P, A)
    scores = (act * wf).sum(-1) + bf[0]
    alpha = torch.softmax(scores.float(), dim=-1)  # (B, k, P)
    ctx = torch.matmul(alpha.to(enc.dtype), enc)  # (B, k, D)
    gate = torch.sigmoid(F.linear(h, wg, bg)).view(b, k, d)
    out = (gate * ctx.to(gate.dtype)).to(enc.dtype)
    return out.reshape(b * k, d), alpha.reshape(b * k, p)


def fused_attention(enc, att_enc, h, wd, bd, wf, bf, wg, bg,
                    rows_per_image=1):
    """(gated context (B*k, D) in the input dtype, alpha (B*k, P) f32).

    CPU tensors take the plain version; CUDA tensors launch K1 or raise.
    ``fused_attention.launches`` counts the kernel's launches.
    """
    if enc.device.type == "cpu":
        return fused_attention_reference(enc, att_enc, h, wd, bd, wf, bf,
                                         wg, bg, rows_per_image)
    return _launch(enc, att_enc, h, wd, bd, wf, bf, wg, bg, rows_per_image)


fused_attention.launches = 0


def _check(enc, att_enc, h, wd, bd, wf, bf, wg, bg, k):
    tensors = dict(enc=enc, att_enc=att_enc, h=h, wd=wd, bd=bd, wf=wf,
                   bf=bf, wg=wg, bg=bg)
    for name, t in tensors.items():
        if t.device != enc.device:
            raise ValueError("K1: {} is on {}, enc on {}".format(
                name, t.device, enc.device))
        if t.dtype != enc.dtype:
            raise TypeError("K1: {} is {}, enc is {}".format(
                name, t.dtype, enc.dtype))
        if not t.is_contiguous():
            raise ValueError("K1: {} must be contiguous".format(name))
    if enc.device.type != "cuda":
        raise ValueError("K1 runs on CUDA tensors, got {}".format(enc.device))
    if enc.dtype not in _DTYPE_CODES:
        raise TypeError("K1 takes float32 or bfloat16, got {}".format(
            enc.dtype))
    if enc.dim() != 3 or att_enc.dim() != 3 or h.dim() != 2:
        raise ValueError("K1: enc and att_enc are (B, P, *), h is (B*k, H)")
    b, p, d = enc.shape
    a = att_enc.shape[2]
    hd = h.shape[1]
    expect = dict(att_enc=(b, p, a), h=(b * k, hd), wd=(a, hd), bd=(a,),
                  wf=(a,), bf=(1,), wg=(d, hd), bg=(d,))
    for name, shape in expect.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError("K1: {} has shape {}, expected {}".format(
                name, tuple(tensors[name].shape), shape))
    if not 1 <= k <= _MAX_ROWS_PER_IMAGE:
        raise ValueError("K1 takes 1..{} rows per image, got {}".format(
            _MAX_ROWS_PER_IMAGE, k))
    # Shared memory of the scores kernel, then of the context kernel
    # (csrc/attention_common.cuh: k att_dec rows and wf; k softmax rows,
    # their transpose (P, 8) and a ring of 6 x 8 pixels of 512 columns).
    ring = 6 * 8 * 512 * enc.element_size()
    if max((k + 1) * a * 4, -(-k * p // 4) * 16 + p * 32 + ring) > _MAX_SMEM:
        raise ValueError("K1: k={}, P={}, A={} exceed its shared memory"
                         .format(k, p, a))
    return b, p, d, a, hd


def _launch(enc, att_enc, h, wd, bd, wf, bf, wg, bg, k):
    b, p, d, a, hd = _check(enc, att_enc, h, wd, bd, wf, bf, wg, bg, k)
    lib = kernels.load("fused_attention")
    rows = b * k
    f32 = dict(dtype=torch.float32, device=enc.device)
    att_dec = torch.empty(rows, a, **f32)
    gate = torch.empty(rows, d, **f32)
    scores = torch.empty(rows, p, **f32)
    alpha = torch.empty(rows, p, **f32)
    ctx = torch.empty(rows, d, dtype=enc.dtype, device=enc.device)
    ptrs = [t.data_ptr() for t in (enc, att_enc, h, wd, bd, wf, bf, wg, bg,
                                   att_dec, gate, scores, ctx, alpha)]
    fn = lib.icd_fused_attention
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(enc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, b, k, p, d, a, hd, _DTYPE_CODES[enc.dtype], stream)
    if err != 0:
        raise RuntimeError("K1 launch failed: CUDA error {}".format(err))
    fused_attention.launches += 1
    return ctx, alpha
