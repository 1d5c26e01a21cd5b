"""Greedy serving of the LSTM baseline through
``icd_tpu_torch.decoding.serve.make_int8_captioner(...,
int8_decoder=True)``, ``icd_tpu_torch.bench``'s default: the static-int8
ResNet-101 backbone calibrated at set-up on the calibration batch, the
bf16 ``embed`` head, and the W8A8 LSTM and vocabulary projection, one
batch a call, its tokens fetched to the host. ``<end>`` is pinned
unreachable, so every caption runs ``max_len`` greedy steps.

The check: after the window, a seeded sample of its served rows is fed,
token by token, to the plain float32 reference. A greedy token is its
step's highest logit, so ``greedy_gap`` is the widest amount by which a
served token's reference logit lies below the reference's best at that
step.

The control (variant ``control``): the reference itself, every
convolution and product on int4 operands, in the program's place: the
step below the configuration's int8.
"""

import time

import torch

from .. import serving, traffic as gen, weights as W
from ..counts import peaks, serve as cs
from ..reference import baseline as ref_base, exact_f32, quant


class Int4Captioner:
    """The reference on int4 operands, as a captioner."""

    def __init__(self, w, cfg, max_len):
        self.w, self.cfg, self.max_len = w, cfg, max_len

    def encode(self, imgs):
        imgs = torch.as_tensor(imgs).to(self.w["embed.weight"].device)
        return ref_base.features(self.w, imgs, self.cfg["resnet_depths"],
                                 quant.products(4), quant.convolution(4))

    def decode(self, feats):
        return ref_base.greedy(self.w, feats, self.max_len,
                               quant.products(4))

    def __call__(self, imgs):
        return self.decode(self.encode(imgs))


def steps_of(tokens, end_id):
    """The steps the greedy loop ran: up to the last caption's first
    ``<end>``, or all when one has none."""
    ended = tokens == end_id
    first = torch.where(ended.any(1), ended.int().argmax(1) + 1,
                        tokens.shape[1])
    return int(first.max())


def build(cell):
    import torch.nn as nn
    from icd_tpu_torch.decoding.serve import make_int8_captioner
    from icd_tpu_torch.models.baseline import BaselineDecoder
    from icd_tpu_torch.models.encoder import Encoder
    from icd_tpu_torch.models.resnet import ResNet

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    vocab = serving.Vocab(cfg["vocab_size"])
    pool = gen.image_pool(tr, cell.seed)
    calib = gen.calibration(tr, cell.seed)
    cell.mark("inputs")
    w = W.make(cfg, gen.torch_seed(cell.seed, "weights"), dev)
    W.adjust(w, cfg, tr, gen.to_torch(calib, dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cell.mark("weights")

    d, e, h, v = (W.encoder_dim(cfg), cfg["embed_size"], cfg["decoder_dim"],
                  cfg["vocab_size"])
    max_len = tr["max_len"]
    if cell.variant == "control":
        captioner = Int4Captioner(w, cfg, max_len)
    else:
        with torch.device("meta"):
            resnet = ResNet(cfg["resnet_depths"], cfg["resnet_widths"])
            embed = nn.Linear(d, e)
            decoder = BaselineDecoder(v, e, h)
        encoder = Encoder(W.load(resnet, w, "resnet."),
                          W.load(embed, w, "embed."))
        decoder = W.load(decoder, w, "decoder.")
        captioner = make_int8_captioner(
            encoder, decoder, vocab.start, vocab.end, max_len=max_len,
            compute_dtype=getattr(torch, tr["dtype"]), calib_imgs=calib,
            int8_decoder=True, device=dev)
        del encoder, decoder
    if cell.fault is not None:
        captioner = cell.fault(captioner)
    proxy = serving.Proxy(captioner, dev,
                          lambda toks: steps_of(toks, vocab.end))
    b = tr["batch"]
    enc_s = (b * cs.resnet_gflop(cfg["resnet_depths"], cfg["resnet_widths"],
                                 tr["image_size"]) * 1e9
             / peaks.INT8_OP_PER_S
             + cs.baseline_head_gflop(b, d, e) * 1e9 / peaks.BF16_FLOP_PER_S)
    step_s = cs.baseline_step_gflop(b, e, h, v) * 1e9 / peaks.INT8_OP_PER_S

    def work_s(steps):
        return enc_s + steps * step_s

    def call(state, rows):
        tokens = state.proxy(pool[rows]).cpu()
        return tokens.tolist(), time.perf_counter()

    cell.mark("program")
    state = serving.Served(cell, call, proxy, work_s)
    state.w, state.pool = w, pool
    serving.warm_up(state)
    return state


def window(state, seconds):
    return serving.window(state, seconds)


def traced(state, tracer):
    from icd_tpu_torch.utils.benchmarking import launches

    return serving.traced(state, tracer, launches)


def check(state):
    cell = state.cell
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    picked = serving.sample(state, tr["sample_tokens"], tr["sample_most"])
    serving.free(state)
    exact_f32()
    rows = [state.requests[i].rows[j] for i, j, _ in picked]
    served = gen.to_torch(serving.pad([t for _, _, t in picked])[0], dev)
    with torch.no_grad():
        logits = ref_base.teacher_forced_logits(
            state.w, gen.to_torch(state.pool[rows], dev), served,
            cfg["resnet_depths"])
        mine = logits.gather(2, served[..., None])[..., 0]
        gap = float((logits.max(dim=2).values - mine).max())
    return [("greedy_gap", gap, cell.limits["greedy_gap"]["limit"])]
