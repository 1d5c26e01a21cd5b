"""Beam-search (k = 5) serving throughput of the attention model on one
card: f32, bf16 and the static-int8 encoder (the port of
``tools/bench_beam.py:23-92``)::

    python -m icd_tpu_torch.bench_beam [--skip-f32] [--device cuda|cpu]

The tool's workload: a batch of 64 uint8 224x224 images, the attention
model at full width (V = 10,000), each batch encoded and beam-searched
through ``decoding/beam.py:beam_search_batched`` (``make_beam_captioner``),
which takes each step's attention and gate from K1
(``csrc/fused_attention.cu``), once a step. Rows, in the tool's order:

- ``f32``: encoder and decoder in f32, TF32 off (skipped under
  ``--skip-f32``);
- ``bf16``: both in bf16;
- ``int8-enc``: the static-int8 backbone calibrated on the batch, the
  bf16 decoder.

The search stops when every image's beams have retired, as the tool's
while loop does, so ``<end>`` is not pinned: each row prints the steps
of its searches and K1's launches beside the units (batches) it ran.
The weights come from ``torch.Generator``s seeded 0 (encoder) and 1
(decoder), the images from one seeded 2; the values are not JAX's, and
a random decoder's beams may run the whole 51-step budget.

Timing (``utils/benchmarking.py``): two warm-up calls, then three
trials, each captioning the batch 4 times and fetching the sum of the
sequences; a row is the fastest trial over 4. Prints one line a row,
then ``{"tool", "rows", "card"}``.
"""

import argparse
import functools
import json

import torch

from .bench import images
from .bench_attention import models
from .decoding.beam import MAX_STEPS
from .device import resolve_device
from .utils.benchmarking import print_row, result, timed_row

BATCH = 64
VOCAB = 10000
REPEATS = 4
TRIALS = 3
BEAM = 5
IMAGE_SIZE = 224
LABELS = ("f32", "bf16", "int8-enc")


def measure(encoder, decoder, imgs, repeats=REPEATS, trials=TRIALS,
            skip_f32=False, max_steps=MAX_STEPS, device=None):
    """The tool's rows on ``imgs`` with the given f32 models (start and
    end ids V - 3 and V - 2). Returns the rows."""
    from .decoding.beam import beam_search_batched
    from .decoding.serve import make_beam_captioner

    device = resolve_device(device)
    vocab = decoder.fc.out_features
    beam_fn = functools.partial(beam_search_batched, max_steps=max_steps)
    ids = dict(start_id=vocab - 3, end_id=vocab - 2, beam_size=BEAM,
               device=device, beam_fn=beam_fn)
    variants = [("bf16", torch.bfloat16, False),
                ("int8-enc", torch.bfloat16, True)]
    if not skip_f32:
        variants.insert(0, ("f32", torch.float32, False))
    rows = []
    for label, dtype, int8 in variants:
        captioner = make_beam_captioner(
            encoder, decoder, compute_dtype=dtype,
            calib_imgs=imgs if int8 else None, **ids)
        steps = []

        def call(i):
            total = 0
            for _ in range(repeats):
                out = captioner(imgs)
                steps.append(out["steps"])
                total = total + out["seq"].sum()
            return int(total)

        r = timed_row(label, call, trials, repeats, imgs.shape[0],
                      "captions/s", device)
        r["steps"] = sorted(set(steps))
        print_row(r, "steps", "units", "k1_launches")
        rows.append(r)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-f32", action="store_true",
                        help="leave out the f32 row")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    encoder, decoder = models(device, pin=False)
    imgs = images(BATCH, IMAGE_SIZE, device, seed=2)
    rows = measure(encoder, decoder, imgs, skip_f32=args.skip_f32,
                   device=device)
    print(json.dumps(result("bench_beam", rows, device)), flush=True)


if __name__ == "__main__":
    main()
