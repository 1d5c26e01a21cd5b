"""The port's spans (``utils.profiling.annotate``), on the CPU at tiny
widths: recorded whenever a ``torch.profiler`` records, one shared no-op
context otherwise.

- a profiled ``caption_images`` over ``make_beam_captioner`` has one
  ``serve_load``, ``serve_upload``, ``serve_fetch`` and ``serve_detok`` a
  batch, a ``beam_step`` a decode step and a ``beam_sync`` a step (one
  more where the loop stops on its check), no sync inside a step;
- the int8 greedy baseline's ``greedy_step`` / ``greedy_sync`` likewise;
- a profiled ``train_epoch`` of 3 staged batches has 3 ``train_step``,
  each holding its six phases, which cover nearly all of it, a
  ``train_wait`` a fetch and a ``train_drain``; every span is on the
  thread that dispatches;
- tokens and losses are the same with and without a profiler.
"""

import json
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

from icd_tpu_torch.beam_eval import caption_images
from icd_tpu_torch.decoding.serve import (make_beam_captioner,
                                          make_int8_captioner)
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.encoder import Encoder, EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.testing import steered_decoder
from icd_tpu_torch.training import attention as ta
from icd_tpu_torch.training import common
from icd_tpu_torch.utils import profiling

DEPTHS, WIDTHS = (1, 1, 1, 1), (4, 4, 8, 8)
DIM = WIDTHS[-1] * 4  # the tiny backbone's channels
V = 30
START, END = V - 3, V - 2
BATCH = 4
PHASES = ("train_trunk", "train_decoder", "train_backward", "train_clip",
          "train_adam", "train_bn")


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _resnet(seed):
    return init_resnet(torch.Generator().manual_seed(seed), DEPTHS, WIDTHS,
                       device="cpu")


def _vocab():
    return types.SimpleNamespace(i2w=["w{}".format(i) for i in range(V)])


def _spans(fn, tmp_path):
    """(fn's result, [(name, start_us, end_us, tid)] of the
    ``user_annotation`` events of a profile of ``fn()``)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"],
                    e["tid"]) for e in events
                   if e.get("cat") == "user_annotation")
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


class _Counted:
    """A captioner that keeps each call's output."""

    def __init__(self, captioner):
        self.captioner, self.outs = captioner, []

    def __call__(self, imgs):
        self.outs.append(self.captioner(imgs))
        return self.outs[-1]


def _beam():
    return make_beam_captioner(
        EncoderAttention(_resnet(0)),
        steered_decoder(V, 12, 16, 8, DIM, seed=1, device="cpu"), START,
        END, beam_size=3, compute_dtype=torch.float32, device="cpu")


def _greedy():
    params = BaselineDecoderParams()
    params.hidden_size, params.embed_size, params.vocab_size = 16, 16, V
    g = torch.Generator().manual_seed(2)
    embed = nn.Linear(DIM, params.embed_size)
    with torch.no_grad():
        for p in embed.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / DIM ** 0.5)
    return make_int8_captioner(
        Encoder(_resnet(3), embed),
        init_baseline_decoder(g, params, device="cpu"), START, END,
        max_len=6, compute_dtype=torch.float32,
        calib_imgs=_images(BATCH, seed=9), int8_decoder=True, device="cpu")


def _train_run():
    """``train_epoch`` over 3 staged batches of the attention model's
    step: its losses."""
    encoder = EncoderAttention(_resnet(4))
    decoder = steered_decoder(V, 12, 16, 8, DIM, seed=5, device="cpu")
    args = types.SimpleNamespace(fine_tune_embedding=False, use_bert=False,
                                 encoder_lr=1e-4, decoder_lr=1e-3)
    optimizer = common.make_adam(args, encoder, decoder, None)
    step = ta.make_train_step(encoder, decoder, optimizer, 1.0, 0.5, 5.0)
    rng = np.random.default_rng(6)
    batches = []
    for t in (5, 7, 6):
        caps = rng.integers(1, START, (BATCH, t))
        caps[:, 0], caps[:, -1] = START, END
        batches.append({"imgs": _images(BATCH, seed=t), "captions": caps,
                        "padded_lengths": np.full(BATCH, t)})
    run = ta.batch_step(step, "cpu", torch.Generator().manual_seed(7))
    return common.train_epoch(run, common.stage_batches(batches, "cpu"),
                              num_batches=len(batches), verbose=False)


def test_annotate_is_one_noop_or_a_user_annotation(tmp_path):
    off = profiling.annotate("probe")
    assert profiling.annotate("other") is off
    with off:
        pass

    def probe():
        with profiling.annotate("probe"):
            torch.ones(2).sum()

    _, spans = _spans(probe, tmp_path)
    assert [s[0] for s in spans] == ["probe"]
    assert profiling.annotate("probe") is off


def test_beam_request_spans(tmp_path):
    captioner = _Counted(_beam())
    ids = list(range(2 * BATCH - 1))  # two batches, the last one padded
    imgs = _images(len(ids))
    _, spans = _spans(lambda: caption_images(
        captioner, ids, lambda chunk: imgs[chunk], _vocab(), BATCH,
        log=lambda _: None), tmp_path)
    loads = _named(spans, "serve_load")
    assert len(loads) == 2
    bounds = [s[1] for s in loads] + [float("inf")]
    for i, out in enumerate(captioner.outs):
        mine = [s for s in spans if bounds[i] <= s[1] < bounds[i + 1]]
        for name in ("serve_load", "serve_upload", "serve_fetch",
                     "serve_detok", "beam_backtrack"):
            assert len(_named(mine, name)) == 1, name
        steps = out["steps"]
        assert steps >= 3
        assert len(_named(mine, "beam_step")) == steps
        assert len(_named(mine, "beam_sync")) in (steps, steps + 1)
    for sync in _named(spans, "beam_sync"):
        assert not any(_within(sync, s) for s in _named(spans, "beam_step"))


def test_greedy_spans(tmp_path):
    captioner = _greedy()
    toks, spans = _spans(lambda: captioner(_images(BATCH)), tmp_path)
    ended = toks == END
    last = int(torch.where(ended.any(1), ended.int().argmax(1) + 1,
                           toks.shape[1]).max())
    steps = last - 1  # the loop's steps after step 0
    assert len(_named(spans, "serve_upload")) == 1
    assert len(_named(spans, "greedy_step")) == steps
    assert len(_named(spans, "greedy_sync")) in (steps, steps + 1)
    for sync in _named(spans, "greedy_sync"):
        assert not any(_within(sync, s)
                       for s in _named(spans, "greedy_step"))


def test_train_epoch_spans(tmp_path):
    losses, spans = _spans(_train_run, tmp_path)
    assert len(losses) == 3
    steps = _named(spans, "train_step")
    assert len(steps) == 3
    for outer in steps:
        parts = [s for s in spans if s[0] in PHASES and _within(s, outer)]
        assert sorted(s[0] for s in parts) == sorted(PHASES)
        covered = sum(s[2] - s[1] for s in parts)
        assert covered >= 0.95 * (outer[2] - outer[1])
    assert len(_named(spans, "train_wait")) == 4  # the last fetch ends it
    assert len(_named(spans, "train_drain")) >= 1
    assert {s[3] for s in spans} == {steps[0][3]}


@pytest.mark.parametrize("path", ["beam", "greedy", "train"])
def test_profiling_changes_no_result(path, tmp_path):
    def run():
        if path == "beam":
            return caption_images(_beam(), list(range(BATCH)),
                                  lambda chunk: _images(BATCH)[chunk],
                                  _vocab(), BATCH, log=lambda _: None)
        if path == "greedy":
            return _greedy()(_images(BATCH)).tolist()
        return _train_run()

    plain = run()
    traced, spans = _spans(run, tmp_path)
    assert spans and traced == plain
