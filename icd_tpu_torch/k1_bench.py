"""Time K1 on the card, whole and launch by launch.

    python -m icd_tpu_torch.k1_bench

At the serving shapes (64 images x 5 beams, P=196, D=2048, A=H=512), in
bf16 and f32: each K1 call timed by CUDA events (L2 emptied before it,
the card asleep while the host sets it up), its time kernel by kernel
from torch.profiler (device time of each kernel K1 launches, and the
gap between the events' time and their sum), its bound
(``ops.fused_attention.bound_ms``) and K1's own clock. Prints one JSON
line per measurement and writes them all to
``chiprun_out/k1_bench.json``. Needs a card.
"""

import argparse
import json
import os
import sys

import torch

from .ops.fused_attention import bound_ms as k1_bound_ms
from .utils.benchmarking import (SETTLE_CYCLES, card_line, device_us,
                                 time_ms)

# Serving shapes: bench.py:36-38 and tools/bench_beam.py:16-20.
IMAGES, BEAMS, PIX, ENC_DIM, ATT_DIM, DEC_DIM = 64, 5, 196, 2048, 512, 512

K1_KERNELS = ("k1_gate", "k1_attention")  # the kernels K1 launches


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
        for name in names:
            if name in e.key:
                split[name] += device_us(e) / iters
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


def main(argv=None):
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: needs a CUDA device")
    from .ops.fused_attention import fused_attention

    lines = [dict(card=card_line())]
    print(json.dumps(lines[0]), flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        inputs = k1_inputs(torch.Generator().manual_seed(1), dtype, "cuda")

        def fn():
            return fused_attention(*inputs, rows_per_image=BEAMS)

        # Two readings, so that the line shows their spread.
        ms = [time_ms(fn, flush=flush, settle=True) for _ in range(2)]
        split = kernel_split_us(fn, K1_KERNELS, flush)
        bound, bound_by = k1_bound_ms(inputs, fn())
        line = dict(k1="current", dtype=str(dtype).split(".")[-1],
                    event_ms=ms, kernel_us=split,
                    kernels_sum_us=sum(split.values()),
                    gap_us=min(ms) * 1e3 - sum(split.values()),
                    bound_ms=bound, bound_by=bound_by,
                    clock_us=clock_us(inputs, BEAMS, flush))
        lines.append(line)
        print(json.dumps(line), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k1_bench.json"), "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
