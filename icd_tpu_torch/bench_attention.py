"""Serving throughput of the attention model on one card, greedy: bf16
against the static-int8 backbone, with the float and the W8A8 decoder
(the port of ``tools/bench_attention.py:21-109``)::

    python -m icd_tpu_torch.bench_attention [--device cuda|cpu]

The tool's workload: a batch of 64 uint8 224x224 images, the attention
model at full width (ResNet-101, a 14x14 grid of 2048, A = H = E = 512,
V = 10,000), 25 greedy steps. Rows, in the tool's order:

- ``bf16``: ``make_attention_captioner`` (encoder and decoder cast to
  bf16);
- ``int8``: ``make_int8_attention_captioner``, the backbone calibrated
  on the batch, the bf16 decoder;
- ``int8+dec``: the same act_maxes and the W8A8 decoder (LSTM and fc
  products quantized from the f32 weights).

Every decode step takes its attention and gate from K1
(``csrc/fused_attention.cu``), once a step; each row prints its
launches beside the units (batches) it ran. The weights come from
``torch.Generator``s seeded 0 (encoder) and 1 (decoder), the images
from one seeded 2; the values are not JAX's. ``<end>`` is pinned
unreachable (``bench.pin_end``), as the tool's decode length is fixed
and the port's loop stops at the last ``<end>``.

Timing (``utils/benchmarking.py``): two warm-up calls, then three
trials, each captioning the batch 10 times and fetching the token sum;
a row is the fastest trial over 10. Prints one line a row, then
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
IMAGE_SIZE = 224
LABELS = ("bf16", "int8", "int8+dec")


def models(device, pin=True):
    """The f32 attention encoder (ResNet-101, generator seeded 0) and
    decoder (seeded 1), <end> (V - 2) pinned unless not ``pin``."""
    from .models.attention import (AttentionDecoderParams,
                                   init_attention_decoder)
    from .models.encoder import init_encoder_attention

    params = AttentionDecoderParams()
    params.vocab = range(VOCAB)
    encoder = init_encoder_attention(torch.Generator().manual_seed(0),
                                     device=device)
    decoder = init_attention_decoder(torch.Generator().manual_seed(1),
                                     params, device=device)
    if pin:
        pin_end(decoder, VOCAB - 2)
    return encoder, decoder


def repeat_tokens(captioner, imgs, repeats):
    """The int sum of the tokens of ``repeats`` captionings of ``imgs``."""
    total = 0
    for _ in range(repeats):
        total = total + captioner(imgs)[0].sum()
    return int(total)


def measure(encoder, decoder, imgs, repeats=REPEATS, trials=TRIALS,
            decode_len=DECODE_LEN, device=None):
    """The tool's three rows on ``imgs`` with the given f32 models (start
    and end ids V - 3 and V - 2). Returns the rows."""
    from .decoding.serve import (make_attention_captioner,
                                 make_int8_attention_captioner)

    device = resolve_device(device)
    vocab = decoder.fc.out_features
    ids = (encoder, decoder, vocab - 3, vocab - 2, decode_len)
    rows = []

    def run(label, captioner):
        toks, _ = captioner(imgs)
        r = timed_row(label,
                      lambda i: repeat_tokens(captioner, imgs, repeats),
                      trials, repeats, imgs.shape[0], "captions/s", device,
                      steps=greedy_steps(toks, vocab - 2))
        print_row(r, "steps", "units", "k1_launches")
        rows.append(r)

    run("bf16", make_attention_captioner(*ids, device=device))
    int8 = make_int8_attention_captioner(*ids, calib_imgs=imgs,
                                         device=device)
    run("int8", int8)
    run("int8+dec", make_int8_attention_captioner(
        *ids, act_maxes=int8.act_maxes, int8_decoder=True, device=device))
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
    print(json.dumps(result("bench_attention", rows, device)), flush=True)


if __name__ == "__main__":
    main()
