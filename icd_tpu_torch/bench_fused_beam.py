"""Decode-only beam search (k = 5) on one card: K2, the whole search in
one launch, against the per-step search with an int8 grid and through
K1 (the port of ``tools/bench_fused_beam.py:26-86``)::

    python -m icd_tpu_torch.bench_fused_beam [--skip-xla] [--device cuda|cpu]

The tool's workload: N(0, 1) bf16 grids of shape (B, 196, 2048), B =
``ICD_TPU_BENCH_BATCH`` (default 64), and the attention decoder at full
width (A = H = E = 512, V = 10,000) in bf16, from ``torch.Generator``s
seeded 1 (decoder) and 2 (grids); the values are not JAX's. ``<end>``'s
fc bias is set to -1e9 before the cast, as the tool sets it, so no beam
retires and every search runs the whole budget, ``MAX_STEPS`` = 51
(``decoding/beam.py``). Rows, in the tool's order:

- ``fused``: ``ops.fused_beam.beam_search_fused``, K2
  (``csrc/fused_beam.cu``), one launch a search; the row also prints
  K2's bound at the steps run (``ops.fused_beam.bound_ms``: the bytes K2
  must move at the H100's 3.35 TB/s, or its products at the dense bf16
  peak);
- ``xla-int8grid``: ``beam_search_batched`` with ``int8_grid=True``,
  the grid and its projection held as per-image int8;
- ``xla``: ``beam_search_batched`` (skipped under ``--skip-xla``).

The per-step rows take each step's attention from K1, once a step. The
labels are the tool's; "xla" names the per-step loop, which here is
eager PyTorch. Each row prints its steps and K1's and K2's launches
beside the units (searches) it ran. The tool's ``ICD_TPU_FB_ABLATE``
has no counterpart: the port's kernel has no ablation switch.

Timing (``utils/benchmarking.py``): two warm-up calls, then three
trials, each running 4 searches of the grids and fetching the sum of
their sequences and lengths; a row is the fastest trial over 4. Prints
one line a row, then ``{"tool", "rows", "card"}``.
"""

import argparse
import json
import os

import torch

from .bench import pin_end
from .decoding.beam import MAX_STEPS, beam_search_batched
from .device import resolve_device
from .ops.fused_beam import _operands, beam_search_fused, bound_ms
from .utils.benchmarking import print_row, result, timed_row

BATCH = int(os.environ.get("ICD_TPU_BENCH_BATCH", "64"))
VOCAB = 10000
BEAM = 5
REPEATS = 4
TRIALS = 3
PIX, ENC_DIM = 196, 2048
LABELS = ("fused", "xla-int8grid", "xla")


def decoder(device):
    """The attention decoder (generator seeded 1), <end> (V - 2) pinned,
    cast to bf16."""
    from .models.attention import (AttentionDecoderParams,
                                   init_attention_decoder)

    params = AttentionDecoderParams()
    params.vocab = range(VOCAB)
    dec = init_attention_decoder(torch.Generator().manual_seed(1), params,
                                 device=device)
    pin_end(dec, VOCAB - 2)
    return dec.to(torch.bfloat16).eval()


def grids(batch, device):
    """(batch, 196, 2048) N(0, 1) bf16 grids (generator seeded 2)."""
    gen = torch.Generator().manual_seed(2)
    return torch.randn((batch, PIX, ENC_DIM), generator=gen).to(
        device=device, dtype=torch.bfloat16)


@torch.inference_mode()
def search(mode, dec, grid, beam_size, start_id, end_id,
           max_steps=MAX_STEPS):
    """One beam search of ``grid`` by the row ``mode``: the
    ``beam_search_batched`` dict."""
    if mode == "fused":
        return beam_search_fused(dec, grid, beam_size, start_id, end_id,
                                 max_steps)
    if mode not in ("xla-int8grid", "xla"):
        raise ValueError("unknown mode {!r}".format(mode))
    return beam_search_batched(dec, grid, beam_size, start_id, end_id,
                               max_steps, int8_grid=mode == "xla-int8grid")


def measure(dec, grid, repeats=REPEATS, trials=TRIALS, skip_xla=False,
            max_steps=MAX_STEPS, device=None):
    """The tool's rows on ``grid`` with the decoder ``dec`` (start and end
    ids V - 3 and V - 2, <end> pinned by the caller). Returns the
    rows."""
    device = resolve_device(device)
    vocab = dec.fc.out_features
    modes = list(LABELS[:2] if skip_xla else LABELS)
    rows = []
    for mode in modes:
        steps = []

        def call(i):
            total = 0
            for _ in range(repeats):
                out = search(mode, dec, grid, BEAM, vocab - 3, vocab - 2,
                             max_steps)
                steps.append(out["steps"])
                total = total + out["seq"].sum() + out["seq_len"].sum()
            return int(total)

        r = timed_row(mode, call, trials, repeats, grid.shape[0],
                      "captions/s", device)
        r["steps"] = sorted(set(steps))
        keys = ["steps", "units", "k1_launches", "k2_launches"]
        if mode == "fused":
            with torch.inference_mode():
                ops = _operands(dec, grid)
            r["bound_ms"], r["bound_by"] = bound_ms(ops, BEAM, max(steps))
            keys += ["bound_ms", "bound_by"]
        print_row(r, *keys)
        rows.append(r)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-xla", action="store_true",
                        help="leave out the per-step search through K1")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    rows = measure(decoder(device), grids(BATCH, device),
                   skip_xla=args.skip_xla, device=device)
    print(json.dumps(result("bench_fused_beam", rows, device)), flush=True)


if __name__ == "__main__":
    main()
