"""Time K1 on the card, whole and launch by launch, against an older K1.

    python -m icd_tpu_torch.k1_bench [--parent DIR]

At the serving shapes (64 images x 5 beams, P=196, D=2048, A=H=512), in
bf16 and f32: each K1 call timed by CUDA events (L2 emptied before it,
the card asleep while the host sets it up), and its time kernel by
kernel from torch.profiler (device time of each kernel K1 launches, and
the gap between the events' time and their sum). ``--parent DIR`` also
builds ``DIR/icd_tpu_torch/csrc/fused_attention.cu``, the three-launch
K1 of an older tree (its C interface takes f32 att_dec, gate and scores
scratch), and times it in turns with the current one: parent, current,
current, parent. Prints one JSON line per measurement and writes them
all to ``chiprun_out/k1_bench.json``. Needs a card.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

from . import kernels

SETTLE_CYCLES = 100_000_000  # about 50 ms of the card's clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, same source
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak, same source
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same source

# Serving shapes: bench.py:36-38 and tools/bench_beam.py:16-20.
IMAGES, BEAMS, PIX, ENC_DIM, ATT_DIM, DEC_DIM = 64, 5, 196, 2048, 512, 512

# Kernels of the older, three-launch K1 and of the current one.
PARENT_KERNELS = ("decoder_products", "attention_scores",
                  "attention_context")
CURRENT_KERNELS = ("k1_gate", "k1_attention")


def time_ms(fn, iters=20, warmup=3, flush=None, settle=False):
    """Median ms of ``fn`` on the card, CUDA events around each call;
    ``flush`` (a large tensor) is zeroed before each call to empty L2.
    With ``settle`` the card then sleeps while the host sets the call up,
    so that the events time the card's work and not the host's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        if settle:
            torch.cuda._sleep(SETTLE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def k1_inputs(gen, dtype, device):
    """K1's arguments at the serving shapes, weights at 1/sqrt(fan_in)."""
    rows = IMAGES * BEAMS

    def n(*shape, scale=1.0):
        t = torch.randn(shape, generator=gen) * scale
        return t.to(device=device, dtype=dtype)

    s = DEC_DIM ** -0.5
    return (n(IMAGES, PIX, ENC_DIM), n(IMAGES, PIX, ATT_DIM),
            n(rows, DEC_DIM), n(ATT_DIM, DEC_DIM, scale=s),
            n(ATT_DIM, scale=s),
            n(ATT_DIM, scale=ATT_DIM ** -0.5), n(1, scale=0.1),
            n(ENC_DIM, DEC_DIM, scale=s), n(ENC_DIM, scale=s))


def k1_bound_ms(args, out):
    """Least time for K1's work on an H100: each input read once, each
    output written once, at 3.35 TB/s; its operations at the peak of the
    inputs' type. Returns (ms, "bytes" or "operations")."""
    enc, att_enc, h = args[0], args[1], args[2]
    rows, hd = h.shape
    b, p, d = enc.shape
    a = att_enc.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *out))
    flops = (2 * rows * hd * (a + d)  # the two products of h
             + 4 * rows * p * a  # add, relu, multiply-add per score term
             + 2 * rows * p * d)  # context sum
    peak = BF16_FLOP_PER_S if enc.element_size() == 2 else F32_FLOP_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def kernel_split_us(fn, names, flush, iters=10):
    """Device time of each kernel whose name contains one of ``names``,
    us per call of ``fn``, from torch.profiler over ``iters`` calls (L2
    emptied and the card asleep before each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(SETTLE_CYCLES)
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for name in names:
            if name in e.key:
                split[name] += us / iters
    return split


def clock_us(inputs, rows_per_image, flush):
    """The current K1's own clock on one call (L2 emptied, the card asleep
    before it): each phase's median and largest duration over blocks, and
    when the first and last blocks of each launch start and end, in us
    from the first block's start."""
    from .ops.fused_attention import PHASES, _launch, phase_us

    _launch(*inputs, rows_per_image)
    flush.zero_()
    torch.cuda._sleep(SETTLE_CYCLES)
    _, _, clock = _launch(*inputs, rows_per_image)
    torch.cuda.synchronize()
    g = clock["gate"].cpu().double()
    t = clock["attention"].cpu().double()
    t0 = min(float(g.min()), float(t.min()))
    durations = [g[:, 1] - g[:, 0]] + [t[:, i + 1] - t[:, i]
                                       for i in range(t.shape[1] - 1)]
    out = dict(median=phase_us(clock))
    out["max"] = {name: float(v.max()) / 1e3
                  for name, v in zip(PHASES, durations)}
    for name, c in (("gate", g), ("attention", t)):
        out[name] = dict(first_start=(float(c[:, 0].min()) - t0) / 1e3,
                         last_start=(float(c[:, 0].max()) - t0) / 1e3,
                         first_end=(float(c[:, -1].min()) - t0) / 1e3,
                         last_end=(float(c[:, -1].max()) - t0) / 1e3)
    return out


def parent_k1(parent_dir):
    """The three-launch K1 of an older tree, built from its source: a
    function of fused_attention's arguments that launches it."""
    csrc = os.path.join(parent_dir, "icd_tpu_torch", "csrc")
    src = os.path.join(csrc, "fused_attention.cu")
    digest = hashlib.sha256()
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name), "rb") as f:
            digest.update(f.read())
    out = os.path.join(kernels.BUILD_DIR, "libparent_k1_{}.so".format(
        digest.hexdigest()[:16]))
    if not os.path.exists(out):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(out).icd_fused_attention
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def call(enc, att_enc, h, wd, bd, wf, bf, wg, bg, rows_per_image):
        b, p, d = enc.shape
        a, hd = wd.shape
        rows = b * rows_per_image
        f32 = dict(dtype=torch.float32, device=enc.device)
        scratch = [torch.empty(rows, n, **f32) for n in (a, d, p)]
        alpha = torch.empty(rows, p, **f32)
        ctx = torch.empty(rows, d, dtype=enc.dtype, device=enc.device)
        ptrs = [t.data_ptr() for t in (enc, att_enc, h, wd, bd, wf, bf, wg,
                                       bg, *scratch, ctx, alpha)]
        err = fn(*ptrs, b, rows_per_image, p, d, a, hd, codes[enc.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("parent K1: CUDA error {}".format(err))
        return ctx, alpha

    return call


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of an older tree whose "
                        "three-launch K1 to time beside the current one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: needs a CUDA device")
    from .ops.fused_attention import fused_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lines = [dict(card=card)]
    print(json.dumps(lines[0]), flush=True)
    parent = parent_k1(args.parent) if args.parent else None
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        inputs = k1_inputs(torch.Generator().manual_seed(1), dtype, "cuda")
        kw = dict(rows_per_image=BEAMS)
        runs = []
        if parent is not None:
            runs.append(("parent", lambda: parent(*inputs, **kw),
                         PARENT_KERNELS))
        runs.append(("current", lambda: fused_attention(*inputs, **kw),
                     CURRENT_KERNELS))
        ms = {name: [] for name, _, _ in runs}
        for name, fn, _ in runs + runs[::-1]:  # parent, current, current, parent
            ms[name].append(time_ms(fn, flush=flush, settle=True))
        for name, fn, kernel_names in runs:
            split = kernel_split_us(fn, kernel_names, flush)
            out = fn()
            bound, bound_by = k1_bound_ms(inputs, out)
            line = dict(k1=name, dtype=str(dtype).split(".")[-1],
                        event_ms=ms[name], kernel_us=split,
                        kernels_sum_us=sum(split.values()),
                        gap_us=min(ms[name]) * 1e3 - sum(split.values()),
                        bound_ms=bound, bound_by=bound_by)
            if name == "current":
                line["clock_us"] = clock_us(inputs, BEAMS, flush)
            lines.append(line)
            print(json.dumps(line), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k1_bench.json"), "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
