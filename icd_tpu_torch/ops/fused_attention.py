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
once at 3.35 TB/s). Two launches chained by programmatic dependent
launch: the gate product of all rows, then one cluster of four blocks per
image that streams the image's att_enc and enc rows once with bulk
asynchronous copies from its first microsecond, computes att_dec itself,
scores and sums with a softmax per block, and combines the four blocks'
partial sums through distributed shared memory. Its sums are f32
throughout, the context's weights included (the plain version and the
TPU kernel round alpha to bf16 before that product in bf16); the source
says how the design follows from the bound. ``fused_attention``
launches it for CUDA tensors and raises on what it does not take; for
CPU tensors it runs ``fused_attention_reference``.
"""

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from ..utils.benchmarking import BF16_FLOP_PER_S, F32_FLOP_PER_S, roofline_ms

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS_PER_IMAGE = 8
_MAX_D = 2048  # 256 threads x 8 columns of the context sum
_MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100
# K1's clock: the gate launch's one phase, then the attention launch's.
PHASES = ("gate", "att_dec", "scores", "context", "combine", "store")


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
    ctx, alpha, _ = _launch(enc, att_enc, h, wd, bd, wf, bf, wg, bg,
                            rows_per_image)
    return ctx, alpha


fused_attention.launches = 0


def bound_ms(args, out):
    """Least time for K1's work on an H100: each input (``args``, as
    ``fused_attention`` takes them) read once, each output (ctx, alpha)
    written once, at the HBM rate; its operations at the peak of the
    inputs' type. Returns (ms, "bytes" or "operations")."""
    enc, att_enc, h = args[0], args[1], args[2]
    rows, hd = h.shape
    b, p, d = enc.shape
    a = att_enc.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *out))
    flops = (2 * rows * hd * (a + d)  # the two products of h
             + 4 * rows * p * a  # add, relu, multiply-add per score term
             + 2 * rows * p * d)  # context sum
    return roofline_ms(nbytes, flops, BF16_FLOP_PER_S
                       if enc.element_size() == 2 else F32_FLOP_PER_S)


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
    if d > _MAX_D:
        raise ValueError("K1 takes D <= {}, got {}".format(_MAX_D, d))
    return b, p, d, a, hd


def _sizes(lib, b, k, p, d, a, hd, dtype):
    """(shared memory of an attention block in bytes, gate blocks,
    attention blocks, stamps a gate block writes, stamps an attention
    block writes), from the library."""
    fn = lib.icd_fused_attention_sizes
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(b, k, p, d, a, hd, _DTYPE_CODES[dtype], out)
    if err != 0:
        raise RuntimeError("K1 sizes: CUDA error {}".format(err))
    return tuple(out)


def _launch(enc, att_enc, h, wd, bd, wf, bf, wg, bg, k):
    """Launch K1 on the current stream: (ctx, alpha, clock), where clock
    holds the ``gate`` launch's stamps (blocks, 2) and the ``attention``
    launch's (blocks, 6), in ns of the card's clock (see ``phase_us``)."""
    b, p, d, a, hd = _check(enc, att_enc, h, wd, bd, wf, bf, wg, bg, k)
    lib = kernels.load("fused_attention")
    smem, gate_blocks, att_blocks, gate_stamps, att_stamps = _sizes(
        lib, b, k, p, d, a, hd, enc.dtype)
    if smem > _MAX_SMEM:
        raise ValueError("K1: k={}, P={}, D={}, A={} need {} bytes of shared "
                         "memory a block, more than {}".format(
                             k, p, d, a, smem, _MAX_SMEM))
    rows = b * k
    dev = enc.device
    gate = torch.empty(rows, d, dtype=torch.float32, device=dev)
    alpha = torch.empty(rows, p, dtype=torch.float32, device=dev)
    ctx = torch.empty(rows, d, dtype=enc.dtype, device=dev)
    n_gate = gate_blocks * gate_stamps
    clock = torch.empty(n_gate + att_blocks * att_stamps, dtype=torch.int64,
                        device=dev)
    ptrs = [t.data_ptr() for t in (enc, att_enc, h, wd, bd, wf, bf, wg, bg,
                                   gate, ctx, alpha, clock)]
    fn = lib.icd_fused_attention
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, b, k, p, d, a, hd, _DTYPE_CODES[enc.dtype], stream)
    if err != 0:
        raise RuntimeError("K1 launch failed: CUDA error {}".format(err))
    fused_attention.launches += 1
    return ctx, alpha, dict(
        gate=clock[:n_gate].view(gate_blocks, gate_stamps),
        attention=clock[n_gate:].view(att_blocks, att_stamps))


def phase_us(clock):
    """K1's clock as microseconds: for each of ``PHASES`` the median over
    blocks of its duration in a block, and ``span``, from the first
    block's start to the last block's end over both launches."""
    g = clock["gate"].cpu().double()
    t = clock["attention"].cpu().double()
    durations = [g[:, 1] - g[:, 0]] + [t[:, i + 1] - t[:, i]
                                       for i in range(t.shape[1] - 1)]
    if len(durations) != len(PHASES):
        raise ValueError("K1's clock has {} phases, PHASES names {}".format(
            len(durations), len(PHASES)))
    out = {name: float(v.median()) / 1e3
           for name, v in zip(PHASES, durations)}
    start = min(float(g[:, 0].min()), float(t[:, 0].min()))
    end = max(float(g[:, 1].max()), float(t[:, -1].max()))
    out["span"] = (end - start) / 1e3
    return out
