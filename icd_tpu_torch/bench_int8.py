"""Serving throughput of the baseline model on one card: bf16 against the
static-int8 backbone, with the float and the W8A8 decoder (the port of
``tools/bench_int8.py:36-88``)::

    python -m icd_tpu_torch.bench_int8 [--device cuda|cpu]

The tool's workload: a batch of 64 uint8 224x224 images, the baseline
model at full width (ResNet-101, E = H = 512, V = 10,000), 25 greedy
steps. Rows, in the tool's order:

- ``bf16``: ``make_repeat_captioner``;
- ``int8``: ``make_int8_repeat_captioner``, the backbone calibrated on
  the batch, the float decoder;
- ``int8+dec``: the same act_maxes, ``int8_decoder=True``.

The weights come from ``torch.Generator``s seeded 0 (encoder) and 1
(decoder), the images from one seeded 2, as the tool seeds its
``PRNGKey``s; the values are not JAX's. The tool's loop has a fixed
length and the port's greedy loop stops at the last ``<end>``, so
``<end>`` is pinned unreachable (``bench.pin_end``) and each row prints
the steps it ran. The baseline path launches neither K1 nor K2; each
row prints both counts.

Timing (``utils/benchmarking.py``): two warm-up calls, then three
trials, each a call of the repeat captioner over 10 perturbed copies of
the batch closed by fetching its token checksum; a row is the fastest
trial over 10. Under ``--device cpu`` the run is the same at full size
(heavy); the tests drive ``measure`` small. Prints one line a row, then
``{"tool", "rows", "card"}``.
"""

import argparse
import json

import torch

from .bench import images, pin_end
from .device import resolve_device
from .utils.benchmarking import (greedy_steps, print_row, result,
                                 timed_row)

BATCH = 64
DECODE_LEN = 25
VOCAB = 10000
REPEATS = 10
TRIALS = 3
EMBED = HIDDEN = 512
IMAGE_SIZE = 224
LABELS = ("bf16", "int8", "int8+dec")


def models(device):
    """The f32 encoder (ResNet-101 + embed, generator seeded 0) and the
    baseline decoder (seeded 1) with <end> (V - 2) pinned."""
    from .models.baseline import BaselineDecoderParams, init_baseline_decoder
    from .models.encoder import init_encoder

    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size = VOCAB, EMBED
    params.hidden_size = HIDDEN
    encoder = init_encoder(torch.Generator().manual_seed(0), EMBED,
                           device=device)
    decoder = init_baseline_decoder(torch.Generator().manual_seed(1),
                                    params, device=device)
    pin_end(decoder, VOCAB - 2)
    return encoder, decoder


def measure(encoder, decoder, imgs, repeats=REPEATS, trials=TRIALS,
            decode_len=DECODE_LEN, device=None):
    """The tool's three rows on ``imgs`` with the given f32 models (the
    start and end ids are V - 3 and V - 2). Returns the rows."""
    from .decoding.serve import (make_int8_repeat_captioner,
                                 make_repeat_captioner)

    device = resolve_device(device)
    vocab = decoder.linear.out_features
    ids = dict(start_id=vocab - 3, end_id=vocab - 2, max_len=decode_len,
               repeats=repeats, device=device)
    rows = []

    def run(label, captioner):
        toks = captioner.captioner(imgs)
        r = timed_row(label, lambda i: int(captioner(imgs, 10 + i)),
                      trials, repeats, imgs.shape[0], "captions/s", device,
                      steps=greedy_steps(toks, vocab - 2))
        print_row(r, "steps", "k1_launches", "k2_launches")
        rows.append(r)

    run("bf16", make_repeat_captioner(encoder, decoder, **ids))
    int8 = make_int8_repeat_captioner(encoder, decoder, calib_imgs=imgs,
                                      **ids)
    run("int8", int8)
    run("int8+dec", make_int8_repeat_captioner(
        encoder, decoder, act_maxes=int8.act_maxes, int8_decoder=True,
        **ids))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    encoder, decoder = models(device)
    imgs = images(BATCH, IMAGE_SIZE, device, seed=2)
    rows = measure(encoder, decoder, imgs, device=device)
    print(json.dumps(result("bench_int8", rows, device)), flush=True)


if __name__ == "__main__":
    main()
