"""Training-step throughput on one card: f32 against --amp bf16, and
--amp with the int8 encoder (the port of ``tools/bench_train.py:74-171``)::

    python -m icd_tpu_torch.bench_train [--attention] [--device cuda|cpu]

The tool's workload: the baseline model (E = H = 512), or with
``--attention`` the attention model (A = H = E = 512, dropout 0.5,
alpha_c 1.0), at full width with V = 10,000; a batch of 32 uint8
224x224 images and captions of length 25 drawn uniformly from the
vocabulary. The encoder's backbone is frozen and the decoder trains
whole, its embedding table included, under Adam at 1e-4 without
clipping. The steps are the port's own
(``training/{attention,baseline}.py:make_train_step``), their precision
chosen by ``training.common.train_precision`` as the train CLI chooses
it. Rows, in the tool's order:

- ``f32``: TF32 off;
- ``amp-bf16``: ``--amp``;
- ``amp+int8enc``: ``--amp --int8_encoder`` (the trunk BN-adapted on the
  batch and calibrated in bf16 by ``prepare_int8_encoder``).

Each row starts from the same weights (a copy of the models) and runs
no kernel of ``ops/``: each row prints K1's and K2's launches, 0. The
weights come from ``torch.Generator``s seeded 0 (encoder) and 1
(decoder), the images and captions from ones seeded 2 and 3; the values
are not JAX's.

Timing (``utils/benchmarking.py``): two warm-up calls, then three
trials, each 10 steps on the batch closed by fetching the sum of their
losses; a row is the fastest trial over 10: ms/step and images/s.

MFU is the tool's (``train_step_mfu``): model GFLOP counted as the tool
counts them, the frozen ResNet-101's forward at 15.6 GFLOP an image and
the decoder's forward and backward (``decoder_train_gflops``), over the
H100 SXM's dense peaks (NVIDIA's data sheet) per component, as the tool
splits them: f32 67 TFLOP/s for the f32 row, bf16 989 TFLOP/s for the
--amp rows, and int8 1,979 TOP/s for the int8 encoder. The tool's v5e
peaks do not carry over to this card. Under ``--device cpu`` MFU is
null. Prints one line a row, then ``{"tool", "rows", "card"}``.
"""

import argparse
import copy
import json
import types

import torch

from .bench import images
from .device import resolve_device, use_exact_f32
from .utils.benchmarking import (BF16_FLOP_PER_S, F32_FLOP_PER_S,
                                 INT8_OP_PER_S, RESNET101_GFLOP, print_row,
                                 result, timed_row)

BATCH = 32
CAP_LEN = 25
VOCAB = 10000
REPEATS = 10
TRIALS = 3
IMAGE_SIZE = 224
ENC_DIM, P_PIX = 2048, 196
LABELS = ("f32", "amp-bf16", "amp+int8enc")
# (compute dtype, int8 encoder, encoder peak, decoder peak) of each row.
ROWS = {"f32": (None, False, F32_FLOP_PER_S, F32_FLOP_PER_S),
        "amp-bf16": (torch.bfloat16, False, BF16_FLOP_PER_S,
                     BF16_FLOP_PER_S),
        "amp+int8enc": (torch.bfloat16, True, INT8_OP_PER_S,
                        BF16_FLOP_PER_S)}


def decoder_train_gflops(attention, e=512, h=512, a=512, v=VOCAB,
                         b=BATCH, t=CAP_LEN):
    """Model GFLOPs of one decoder forward + backward, 3x the forward's
    products (tools/bench_train.py:36-72; elementwise work, the softmax
    and the embedding gather left out).

    Baseline: the feature as timestep 0, so the LSTM runs t steps over
    (e + h) -> 4h gates, then fc h -> v each step. Attention: the
    hoisted encoder projection, then each of the t - 1 decode steps'
    dec_att / score / context / gate chain over P_PIX pixels and the
    (e + 2048 + h) -> 4h LSTM, then the batched fc.
    """
    if not attention:
        fwd = (2 * b * ENC_DIM * e                 # encoder head
               + 2 * b * t * (e + h) * 4 * h       # LSTM gates
               + 2 * b * t * h * v)                # vocab projection
    else:
        td = t - 1                                 # decode steps
        fwd = (2 * b * P_PIX * ENC_DIM * a         # enc_att (hoisted)
               + 2 * 2 * b * ENC_DIM * h           # init h, c
               + td * (2 * b * h * a               # dec_att
                       + 2 * b * P_PIX * a         # score
                       + 2 * b * P_PIX * ENC_DIM   # context
                       + 2 * b * h * ENC_DIM       # f_beta gate
                       + 2 * b * (e + ENC_DIM + h) * 4 * h)  # LSTM
               + 2 * b * td * h * v)               # vocab projection
    return 3.0 * fwd / 1e9


def train_step_mfu(step_seconds, attention, label, b=BATCH, t=CAP_LEN):
    """Speed-of-light time over the measured step (the tool's
    ``train_step_mfu``), at the row ``label``'s peak per component."""
    _, _, enc_peak, dec_peak = ROWS[label]
    light = (b * RESNET101_GFLOP * 1e9 / enc_peak
             + decoder_train_gflops(attention, b=b, t=t) * 1e9 / dec_peak)
    return light / step_seconds


def models(attention, device):
    """The f32 encoder (generator seeded 0) and decoder (seeded 1) of the
    baseline model, or with ``attention`` of the attention model."""
    from .models.encoder import init_encoder, init_encoder_attention

    enc_gen = torch.Generator().manual_seed(0)
    dec_gen = torch.Generator().manual_seed(1)
    if attention:
        from .models.attention import (AttentionDecoderParams,
                                       init_attention_decoder)

        params = AttentionDecoderParams()
        params.vocab = range(VOCAB)
        return (init_encoder_attention(enc_gen, device=device),
                init_attention_decoder(dec_gen, params, device=device))
    from .models.baseline import BaselineDecoderParams, init_baseline_decoder

    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size, params.hidden_size = VOCAB, 512, 512
    return (init_encoder(enc_gen, 512, device=device),
            init_baseline_decoder(dec_gen, params, device=device))


def captions(n, length, vocab, device):
    """(n, length) ids uniform over the vocabulary (generator seeded 3)."""
    gen = torch.Generator().manual_seed(3)
    return torch.randint(0, vocab, (n, length), generator=gen).to(device)


def trainer(encoder, decoder, imgs, label, attention):
    """A copy of the models and the row ``label``'s step on ``imgs``:
    ``step(captions)`` -> the loss on the device."""
    from .training import attention as ta
    from .training import baseline as tb
    from .training.common import (make_optimizer, train_precision,
                                  trainable_parameters)

    enc, dec = copy.deepcopy(encoder), copy.deepcopy(decoder)
    enc_params, dec_params = trainable_parameters(
        enc, dec, fine_tune_embedding=True)
    optimizer = make_optimizer(enc_params, dec_params, 1e-4, 1e-4)
    _, int8, _, _ = ROWS[label]
    args = types.SimpleNamespace(amp=label != "f32", int8_encoder=int8,
                                 checkpoint=None)
    dtype, qresnet = train_precision(args, enc.resnet,
                                     [{"imgs": imgs.cpu().numpy()}])
    if not attention:
        step = tb.make_train_step(enc, dec, optimizer, 0,
                                  compute_dtype=dtype, qresnet=qresnet)
        return lambda caps: step(imgs, caps)
    step = ta.make_train_step(enc, dec, optimizer, alpha_c=1.0,
                              dropout_rate=0.5, compute_dtype=dtype,
                              qresnet=qresnet)
    gen = torch.Generator(imgs.device).manual_seed(7)

    def run(caps):
        lengths = torch.full((caps.shape[0],), caps.shape[1] - 1,
                             dtype=torch.long, device=caps.device)
        return step(imgs, caps, lengths, gen)

    return run


def measure(encoder, decoder, imgs, caps, attention, repeats=REPEATS,
            trials=TRIALS, device=None):
    """The tool's three rows with the given f32 models (``attention``
    says which family) on one batch of ``imgs`` and ``caps``. Returns
    the rows."""
    device = resolve_device(device)
    use_exact_f32()
    cuda = device.type == "cuda"
    b, t = caps.shape
    rows = []
    for label in LABELS:
        step = trainer(encoder, decoder, imgs, label, attention)

        def call(i):
            total = 0
            for _ in range(repeats):
                total = total + step(caps)
            return total.item()

        r = timed_row(label, call, trials, repeats, b, "images/s", device,
                      per="step")
        r["mfu"] = (train_step_mfu(r["ms"] / 1e3, attention, label, b, t)
                    if cuda else None)
        r["model_gflop"] = (b * RESNET101_GFLOP
                            + decoder_train_gflops(attention, b=b, t=t))
        print_row(r, "mfu", "k1_launches", "k2_launches")
        rows.append(r)
        del step
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--attention", action="store_true",
                        help="the attention model (default: baseline)")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    encoder, decoder = models(args.attention, device)
    imgs = images(BATCH, IMAGE_SIZE, device, seed=2)
    rows = measure(encoder, decoder, imgs,
                   captions(BATCH, CAP_LEN, VOCAB, device), args.attention,
                   device=device)
    tool = "bench_train" + (" --attention" if args.attention else "")
    print(json.dumps(result(tool, rows, device)), flush=True)


if __name__ == "__main__":
    main()
