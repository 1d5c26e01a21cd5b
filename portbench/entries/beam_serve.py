"""Beam-search serving of the soft-attention captioner through
``icd_tpu_torch.beam_eval.caption_images`` over
``icd_tpu_torch.decoding.serve.make_beam_captioner`` (the float encoder
at the traffic's ``dtype``; the per-step beam of
``decoding/beam.py``, one K1 launch a step, or with ``"beam":
"fused"`` the whole search in one K2 launch, beam_eval's ``--fused``).

The check: of each request the window served, the entry keeps the
longest caption's row and one row drawn from the seed, with the
attention maps the program returned for it; after the window, a seeded
sample of those captions (the longest of all in it) is fed, token by
token, to the plain reference in float32 on the reference's own grid.

- ``topk_rank``: a beam keeps a token only while it is among the best
  ``beam_size`` continuations of its beam, so every served token ranks
  within its step's top ``beam_size`` of the program's log-probabilities;
  the worst rank (1 the best) of a served token among the reference's.
  Rounding moves a token past the ``beam_size``-th only at near ties,
  by a few places; an altered token lands thousands of places down.
- ``alpha_gap``: the widest L1 distance, over the sample's steps,
  between the attention map the program returned for a served token and
  the reference's (the grid, K1's or K2's attention and the LSTM state
  that feeds it).
- ``unfinished``: the window's captions that came back without
  ``<end>``; the traffic's steering ends every caption long before 50
  steps.

The control (variant ``control``): the program with its int8 encoder
switched on (beam_eval's default ``--int8``, calibrated on the
calibration batch), the step below the configuration's bf16.
"""

import time

import torch

from .. import serving, traffic as gen, weights as W
from ..counts import peaks, serve as cs
from ..reference import attention as ref_att, exact_f32, resnet as ref_res


def _widths(cfg):
    return (cfg["grid"] ** 2, W.encoder_dim(cfg), cfg["attention_dim"],
            cfg["decoder_dim"], cfg["embed_size"], cfg["vocab_size"])


def build(cell):
    from icd_tpu_torch.beam_eval import caption_images
    from icd_tpu_torch.decoding.beam import beam_search_batched
    from icd_tpu_torch.decoding.serve import make_beam_captioner
    from icd_tpu_torch.models.attention import AttentionDecoder
    from icd_tpu_torch.models.encoder import EncoderAttention
    from icd_tpu_torch.models.resnet import ResNet
    from icd_tpu_torch.ops.fused_beam import beam_search_fused

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

    p, d, a, h, e, v = _widths(cfg)
    with torch.device("meta"):
        resnet = ResNet(cfg["resnet_depths"], cfg["resnet_widths"])
        decoder = AttentionDecoder(v, a, h, e, d)
    encoder = EncoderAttention(W.load(resnet, w, "resnet."))
    decoder = W.load(decoder, w, "decoder.")
    beam_fn = {"per_step": beam_search_batched,
               "fused": beam_search_fused}[tr["beam"]]
    int8 = {"calib_imgs": calib} if cell.variant == "control" else {}
    captioner = make_beam_captioner(
        encoder, decoder, vocab.start, vocab.end, beam_size=cfg["beam_size"],
        compute_dtype=getattr(torch, tr["dtype"]), device=dev,
        beam_fn=beam_fn, **int8)
    del encoder, decoder
    if cell.fault is not None:
        captioner = cell.fault(captioner)
    proxy = serving.Proxy(captioner, dev, lambda out: int(out["steps"]))
    b, k = tr["batch"], cfg["beam_size"]
    enc_s = b * cs.resnet_gflop(cfg["resnet_depths"], cfg["resnet_widths"],
                                tr["image_size"]) * 1e9
    req_s = cs.attention_request_gflop(b, p, d, a) * 1e9
    step_s = cs.attention_step_gflop(b * k, p, d, a, h, e, v) * 1e9
    peak = peaks.BY_DTYPE[{"bfloat16": "bf16", "float32": "f32"}[tr["dtype"]]]

    def work_s(steps):
        return (enc_s + req_s + steps * step_s) / peak

    def call(state, rows):
        marks = []
        results = caption_images(
            state.proxy, [int(r) for r in rows], lambda ids: pool[ids],
            vocab, b, log=lambda _: marks.append(time.perf_counter()))
        tokens = [[vocab.w2i[x] for x in res["caption"].split()] + [vocab.end]
                  if res["caption"] else [] for res in results]
        return tokens, marks[-1]

    cell.mark("program")
    draw = gen.stream(cell.seed, "keep")

    def keep(state, tokens):
        """The alphas of the request's longest caption and of a seeded
        row, each over its served tokens' steps."""
        longest = max(range(len(tokens)), key=lambda j: len(tokens[j]))
        rows = {longest, int(draw.integers(len(tokens)))}
        alphas = state.proxy.last["alphas"]
        return {j: alphas[j, 1:len(tokens[j]) + 1].clone() for j in rows
                if tokens[j]}

    state = serving.Served(cell, call, proxy, work_s, keep)
    state.w, state.pool, state.vocab = w, pool, vocab
    serving.warm_up(state)
    return state


def window(state, seconds):
    return serving.window(state, seconds)


def _launches():
    from icd_tpu_torch.ops.fused_attention import fused_attention
    from icd_tpu_torch.ops.fused_beam import beam_search_fused

    return fused_attention.launches, beam_search_fused.launches


def traced(state, tracer):
    return serving.traced(state, tracer, _launches)


def check(state):
    cell = state.cell
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    unfinished = sum(1 for r in state.requests for t in r.tokens if not t)
    picked = serving.sample(state, tr["sample_tokens"], tr["sample_most"])
    serving.free(state)
    exact_f32()
    rank = alpha_gap = float("inf")
    if picked:
        rows = [state.requests[i].rows[j] for i, j, _ in picked]
        served, filled = serving.pad([t for _, _, t in picked])
        inputs, _ = serving.pad([[state.vocab.start] + t[:-1]
                                 for _, _, t in picked])
        served = gen.to_torch(served, dev)
        with torch.no_grad():
            grid, _ = ref_res.grid(state.w, gen.to_torch(state.pool[rows], dev),
                                   cfg["resnet_depths"], cfg["grid"])
            logp, alphas = ref_att.teacher_forced_logprobs(
                state.w, grid, gen.to_torch(inputs, dev))
            mine = logp.gather(2, served[..., None])
            ranks = 1 + (logp > mine).sum(dim=2)
            rank = int(torch.where(gen.to_torch(filled, dev), ranks, 0).max())
            alpha_gap = max(
                float((state.requests[i].kept[j] - alphas[n, :len(t)])
                      .abs().sum(dim=1).max())
                for n, (i, j, t) in enumerate(picked))
    lim = cell.limits
    return [("topk_rank", rank, lim["topk_rank"]["limit"]),
            ("alpha_gap", alpha_gap, lim["alpha_gap"]["limit"]),
            ("unfinished", unfinished, lim["unfinished"]["limit"])]
