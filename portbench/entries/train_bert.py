"""Training of the soft-attention captioner on BERT's caption embeddings,
as ``make attention_bert`` trains it (batch 32, ``--use_bert
--fine_tune_embedding --embed_size 768``) and as
``icd_tpu_torch.training.attention.train`` composes it for
``--use_bert``: ``training.common.train_epoch`` over
``training.attention.batch_step(make_train_step(...))``, fed by
``training.common.stage_batches(..., prepare=with_bert(
BertCaptionEmbedder(...)))``, whose producer thread tokenizes each
batch's padded captions, runs BERT's forward on the run's device and
sums its pieces into words while the step trains on the batch before.
float32 with TF32 off, the trunk frozen (train-mode BN), Adam over the
decoder, its table frozen.

The captions' lengths and images cycle ``traffic.train_batches``' pool;
every batch handed out gets new words (``bert_inputs.fresh_captions``),
so that the embedder's caption cache misses as over a real epoch; its
per-word memo is warmed over the whole caption vocabulary at set-up,
as it is within a real epoch's first few hundred batches, and BERT's
CUDA graphs for the batch size are captured there, as ``train`` captures
them (``TorchBert.capture``; none in a program without it). The
WordPiece ``vocab.txt`` is written to ``TMPDIR``
(``bert_inputs.write_wordpiece_vocab``) and read by the program's own
``BertTokenizer``.

The check follows the first three steps in the plain reference
(``reference.bert``, ``reference.train_bert``) and compares:

- ``piece_mismatch``: rows whose piece ids, mask or piece -> word
  segments (the program's ``piece_arrays``) differ from the reference
  tokenizer's and walk's, padded to the program's length;
- ``embed_gap``: the aligned embeddings the step received against the
  reference's (BERT one caption at a time, unpadded, no mask): each
  word row's relative L2 gap, the worst row;
- ``loss_gap``, ``grad_gap``, ``change_gap``, ``bn_gap``: as
  ``entries/train.py`` measures them.

Variants, for the limits' readings: ``control``, the reference with
TF32 on in the program's place; ``bert_tf32``, the program with BERT's
forward in TF32 in the checked steps and the step in float32;
``unpadded``, the program with BERT run over each caption cut to its
length (the embedder's ``lengths``, its eval texts).

Faults (``FAULTS``, for the tests and the limits' readings):
``faults.TRAINING``'s, with ``half_batch`` cutting BERT's embeddings
with the rest of the batch.

``traced`` records every thread, BERT's producer too, and counts
``bert_device_s``: the device time of each operation whose launch (a
``cuda_runtime`` or ``cuda_driver`` event, joined on
``args.correlation``) falls inside a ``bert_forward`` span of the
launching thread. A program whose spans open only under a profiler of
their own thread records none of them, and their metrics are absent.
"""

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
import types

import numpy as np
import torch

from .. import bert_inputs as B, faults, traffic as gen, weights as W
from ..counts import bert as cb, peaks, serve as cs, train as ct
from ..reference import bert as ref_bert, exact_f32
from ..reference import train_bert as ref_train
from ..trace import DEVICE_CATEGORIES
from . import train as plain

CHECKED_STEPS = plain.CHECKED_STEPS
LAUNCHES = ("cuda_runtime", "cuda_driver")


class _Program(plain._Program):
    """The program's train step, its BERT embedder and ``prepare``."""

    def __init__(self, cell, state):
        from icd_tpu_torch.device import use_exact_f32
        from icd_tpu_torch.models.attention import AttentionDecoder
        from icd_tpu_torch.models.bert import BertEncoder
        from icd_tpu_torch.models.bert_embed import (BertCaptionEmbedder,
                                                     caption_keys)
        from icd_tpu_torch.models.bert_tokenize import BertTokenizer
        from icd_tpu_torch.models.encoder import EncoderAttention
        from icd_tpu_torch.models.resnet import ResNet
        from icd_tpu_torch.training.attention import (batch_step,
                                                      make_train_step,
                                                      with_bert)
        from icd_tpu_torch.training.common import make_adam
        from icd_tpu_torch.vocabulary import Vocabulary

        cfg, dev = cell.config, cell.device
        d = W.encoder_dim(cfg)
        with torch.device("meta"):
            resnet = ResNet(cfg["resnet_depths"], cfg["resnet_widths"])
            decoder = AttentionDecoder(cfg["vocab_size"], cfg["attention_dim"],
                                       cfg["decoder_dim"], cfg["embed_size"],
                                       d)
        self.encoder = EncoderAttention(W.load(resnet, state.w, "resnet."))
        self.decoder = W.load(decoder, state.w, "decoder.")
        args = types.SimpleNamespace(
            fine_tune_embedding=cfg["fine_tune_embedding"],
            use_bert=cfg["use_bert"], encoder_lr=cfg["encoder_lr"],
            decoder_lr=cfg["decoder_lr"])
        use_exact_f32()
        self.optimizer = make_adam(args, self.encoder, self.decoder, None)
        step = make_train_step(self.encoder, self.decoder, self.optimizer,
                               cfg["alpha_c"], cfg["dropout"],
                               cfg["grad_clip"])
        if cell.fault is not None:
            step = cell.fault(step, self)
        generator = torch.Generator(dev).manual_seed(state.dropout_seed)
        self.run = batch_step(step, dev, generator)

        vocab = Vocabulary()
        for word in state.words:
            vocab.add_word(word)
        bert = BertEncoder.from_config(cfg["bert"], dev)
        bert.load_state_dict(W.subtree(state.bert_w, "bert."))
        self.embedder = BertCaptionEmbedder(
            vocab, model=bert, tokenizer=BertTokenizer(state.vocab_path),
            device=dev)
        ids = np.arange(1, cfg["vocab_size"] - 3)
        caps = np.resize(ids, (-(-len(ids) // 16), 16))
        self.embedder.piece_arrays(caps, caption_keys(caps))
        # BERT's CUDA graphs for the batch, as ``train`` captures them,
        # up to the length of a row of T words padded with ``<pad>`` (3
        # pieces, as ``<start>`` and ``<end>``): 1 + 3 T. A batch past it
        # needs a caption whose words average over 3 pieces (none in 600
        # batches of two seeds) and runs eagerly. A program without
        # ``capture`` runs BERT eagerly; so does the TF32 variant, since
        # a graph keeps the precision it was captured in.
        capture = getattr(self.embedder.bert, "capture", None)
        if capture is not None and cell.variant != "bert_tf32":
            words = max(b["captions"].shape[1] for b in state.batches)
            capture(cell.traffic["batch"], 1 + 3 * words)
        self.prepare = with_bert(self.embedder)
        if cell.variant == "unpadded":
            def cut(batch):
                return dict(batch, embeddings=self.embedder(
                    batch["captions"], lengths=batch["caption_lengths"]))
            self.prepare = cut
        self.tf32_bert = cell.variant == "bert_tf32"

    def checked(self, batch):
        """``prepare(batch)`` and the piece arrays it tokenized."""
        arrays = []
        inner = self.embedder.piece_arrays

        def spy(captions, keys):
            arrays.append(inner(captions, keys))
            return arrays[-1]

        self.embedder.piece_arrays = spy
        try:
            exact_f32(tf32=self.tf32_bert)
            out = self.prepare(batch)
            if self.tf32_bert and out["embeddings"].is_cuda:
                torch.cuda.synchronize()
        finally:
            exact_f32()
            del self.embedder.piece_arrays
        return arrays[0][:3], out


def half_batch_step(step, program):
    """``faults.half_batch_step``, BERT's embeddings cut with the
    batch."""
    def faulty(imgs, captions, lengths, generator, embeddings, n):
        h = imgs.shape[0] // 2
        return step(imgs[:h], captions[:h], lengths[:h], generator,
                    embeddings[:h], h)
    return faulty


FAULTS = dict(faults.TRAINING, half_batch=half_batch_step)


class _Control(plain._Control):
    """The reference, BERT and step, with TF32 on, as the program."""

    def __init__(self, cell, state):
        cfg, dev = cell.config, cell.device
        self.embedder = ref_bert.Embedder(state.bert_w, cfg["bert"],
                                          state.vocab_path, state.words)
        self.trainer = ref_train.Trainer(state.w, cfg)
        self.generator = torch.Generator(dev).manual_seed(state.dropout_seed)
        self.cfg, self.device, self.grads = cfg, dev, []

    def prepare(self, batch):
        exact_f32(tf32=True)
        return dict(batch, embeddings=self.embedder(batch["captions"]))

    def checked(self, batch):
        return (_padded(self.embedder.pieces(batch["captions"])),
                self.prepare(batch))

    def run(self, batch):
        exact_f32(tf32=True)
        imgs = torch.as_tensor(batch["imgs"]).to(self.device)
        caps = torch.as_tensor(batch["captions"]).to(self.device)
        loss, grads = self.trainer.step(
            imgs, caps, plain._keep(self.generator, caps, self.cfg,
                                    self.device), batch["embeddings"])
        if not self.grads:
            self.grads.append(grads)
        return loss


def _padded(rows):
    """(ids, mask, segments) (B, L) of [(ids, segments)] rows."""
    length = max(len(ids) for ids, _ in rows)
    ids = np.zeros((len(rows), length), np.int64)
    mask = np.zeros_like(ids)
    seg = np.full_like(ids, -1)
    for r, (row_ids, row_seg) in enumerate(rows):
        ids[r, :len(row_ids)], seg[r, :len(row_ids)] = row_ids, row_seg
        mask[r, :len(row_ids)] = 1
    return ids, mask, seg


def _epoch(state, batches, prepare=None):
    from icd_tpu_torch.training.common import stage_batches, train_epoch

    staged = stage_batches(batches, state.cell.device,
                           prepare=prepare or state.program.prepare)
    return train_epoch(state.program.run, staged, num_batches=0,
                       verbose=False)


def _cycle(state, until=None, count=None):
    """Batches of the pool from ``state.next`` on, cycled, each with new
    words, while the clock is under ``until`` or ``count`` remain; the
    captions of each one handed out are recorded in ``state.fed``."""
    v, n = state.cell.config["vocab_size"], 0
    while (until is None or time.perf_counter() < until) and (
            count is None or n < count):
        k = state.next
        batch = B.fresh_captions(state.batches[k % len(state.batches)], v,
                                 state.cell.seed, k)
        state.next += 1
        n += 1
        state.fed.append(batch["captions"])
        yield batch


def build(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    state = types.SimpleNamespace(cell=cell, next=0, fed=[], pieces=None)
    state.batches = gen.train_batches(tr, cfg, cell.seed)
    state.words = B.caption_words(cfg, cell.seed)
    state.vocab_dir = tempfile.mkdtemp(prefix="portbench_bert_")
    state.vocab_path = B.write_wordpiece_vocab(
        os.path.join(state.vocab_dir, "vocab.txt"), cfg, state.words,
        cell.seed)
    cell.mark("inputs")
    state.w = W.make(cfg, gen.torch_seed(cell.seed, "weights"), dev)
    state.bert_w = B.make_bert(cfg["bert"], cell.seed, dev)
    state.dropout_seed = gen.torch_seed(cell.seed, "dropout")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cell.mark("weights")
    kind = _Control if cell.variant == "control" else _Program
    state.program = kind(cell, state)
    cell.mark("program")

    state.losses, state.seen = [], []

    def checked(batch):
        arrays, out = state.program.checked(batch)
        state.seen.append((batch["imgs"], batch["captions"], arrays,
                           out["embeddings"].detach().clone()))
        return out

    for s in range(CHECKED_STEPS):
        state.losses += _epoch(state, _cycle(state, count=1), checked)
        if s == 0:
            state.grad1 = {k: g.detach().clone()
                           for k, g in state.program.first_gradient().items()}
    state.after = {k: p.detach().clone()
                   for k, p in state.program.trained().items()}
    state.bn_after = {k: t.detach().clone()
                      for k, t in state.program.bn_stats().items()}
    cell.mark("checked steps")
    _epoch(state, _cycle(state, count=tr["warmup_steps"]))
    return state


def _row_pieces(state, captions):
    """Each caption's own piece count with ``[CLS]``: the reference
    tokenizer's pieces of each word, summed (a caption's pieces are its
    whitespace words' pieces)."""
    if state.pieces is None:
        tok = ref_bert.Tokenizer(state.vocab_path)
        state.pieces = np.array([len(tok.tokenize(w)) for w in state.words])
    return (1 + state.pieces[captions].sum(axis=1)).tolist()


def _work_s(state, captions):
    """A step's model operations at the float32 peak, as seconds: the
    trunk's forward, the decoder's forward and backward
    (``sat_train_b32``'s counts) and BERT's forward."""
    cfg, tr = state.cell.config, state.cell.traffic
    b, t = captions.shape
    dims = (cfg["grid"] ** 2, W.encoder_dim(cfg), cfg["attention_dim"],
            cfg["decoder_dim"], cfg["embed_size"], cfg["vocab_size"])
    gflop = (b * cs.resnet_gflop(cfg["resnet_depths"], cfg["resnet_widths"],
                                 tr["image_size"])
             + ct.attention_decoder_train_gflop(b, t, *dims))
    bert = cb.forward_flops(_row_pieces(state, captions), cfg["bert"])
    return (gflop * 1e9 + bert) / peaks.F32_FLOP_PER_S


def _counts(state):
    return dict(getattr(getattr(state.program, "embedder", None), "counts",
                        None) or {})


def window(state, seconds):
    b = state.cell.traffic["batch"]
    state.fed = []
    before = _counts(state)
    start = time.perf_counter()
    losses = _epoch(state, _cycle(state, until=start + seconds))
    length = time.perf_counter() - start
    n = len(losses)
    counters = {"window_s": length,
                "work_at_peak_s": sum(_work_s(state, c) for c in state.fed)}
    for k, v in _counts(state).items():
        counters["bert_" + k] = v - before[k]
    print("portbench: embedder counts {}".format(
        {k: v for k, v in counters.items() if k.startswith("bert_")}),
        file=sys.stderr)
    return {"seconds": length, "attempted": n, "failed": 0,
            "metrics": {"train_images_per_s": n * b / length},
            "counters": counters}


@contextlib.contextmanager
def _every_thread(tracer):
    """``tracer.block()`` with every thread's host events recorded: a
    profiler otherwise records only the thread that opened it, and
    BERT's spans are on the producer's."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = tracer.device.type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=config) as prof:
        with tracer.span("window"):
            yield
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            tracer.events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def bert_device_seconds(events):
    """Device seconds of the operations launched inside ``bert_forward``
    spans, on the spans' own threads; None when no such span was
    recorded (a program without it)."""
    spans = {}
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and ev.get("name") == "bert_forward"):
            start = float(ev["ts"])
            spans.setdefault(ev.get("tid"), []).append(
                (start, start + float(ev.get("dur", 0.0))))
    if not spans:
        return None
    launched = set()
    for ev in events:
        corr = ev.get("args", {}).get("correlation")
        if (ev.get("ph") != "X" or ev.get("cat") not in LAUNCHES
                or corr is None):
            continue
        t = float(ev["ts"])
        if any(a <= t <= b for a, b in spans.get(ev.get("tid"), ())):
            launched.add(corr)
    return 1e-6 * sum(float(ev.get("dur", 0.0)) for ev in events
                      if ev.get("ph") == "X"
                      and ev.get("cat") in DEVICE_CATEGORIES
                      and ev.get("args", {}).get("correlation") in launched)


def traced(state, tracer):
    run = state.program.run

    def spanned(batch):
        with tracer.span("step"):
            return run(batch)

    state.program.run = spanned
    state.fed = []
    with _every_thread(tracer):
        _epoch(state, _cycle(state, count=state.cell.traffic["trace_steps"]))
    state.program.run = run
    bert = state.cell.config["bert"]
    counters = {"traced_steps": len(state.fed),
                "bert_bound_s": sum(cb.bound_s(_row_pieces(state, c), bert)
                                    for c in state.fed)}
    device_s = bert_device_seconds(tracer.events)
    if device_s:
        counters["bert_device_s"] = device_s
    return tracer.reading(counters)


def _mismatched_rows(arrays, want):
    """Rows of the program's (ids, mask, segments) that differ from the
    reference's rows padded to the program's length."""
    ids, mask, seg = (np.asarray(a, np.int64) for a in arrays)
    length = ids.shape[1]
    bad = abs(len(ids) - len(want))
    for r, (row_ids, row_seg) in enumerate(want[:len(ids)]):
        n = len(row_ids)
        if n > length:
            bad += 1
            continue
        same = (np.array_equal(ids[r, :n], row_ids)
                and np.array_equal(seg[r, :n], row_seg)
                and mask[r, :n].all() and not mask[r, n:].any()
                and not ids[r, n:].any() and (seg[r, n:] == -1).all())
        bad += not same
    return bad


def _worst_row_gap(got, want):
    num = (got.float() - want).norm(dim=-1)
    return float((num / want.norm(dim=-1)).max())


def check(state):
    cell = state.cell
    cfg, dev = cell.config, cell.device
    state.program = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    exact_f32()
    embedder = ref_bert.Embedder(state.bert_w, cfg["bert"], state.vocab_path,
                                 state.words)
    trainer = ref_train.Trainer(state.w, cfg)
    generator = torch.Generator(dev).manual_seed(state.dropout_seed)
    losses, mismatched, embed_gap = [], 0, 0.0
    for s, (imgs, caps, arrays, got) in enumerate(state.seen):
        mismatched += _mismatched_rows(arrays, embedder.pieces(caps))
        want = embedder(caps)
        embed_gap = max(embed_gap, _worst_row_gap(got, want))
        imgs, caps = gen.to_torch(imgs, dev), gen.to_torch(caps, dev)
        loss, grads = trainer.step(imgs, caps,
                                   plain._keep(generator, caps, cfg, dev),
                                   want)
        losses.append(float(loss))
        if s == 0:
            grad1 = grads
    shutil.rmtree(state.vocab_dir, ignore_errors=True)

    keys = sorted(grad1)
    g_ref = {k: grad1[k].norm() for k in keys}
    g_mine = {k: state.grad1[k].norm() for k in keys}
    g_med = float(torch.stack([g_ref[k] for k in keys]).median())
    d_ref = {k: (trainer.params[k] - state.w[k]).norm() for k in keys}
    d_mine = {k: (state.after[k] - state.w[k]).norm() for k in keys}
    moved = [k for k in keys if float(g_ref[k]) >= 1e-3 * g_med]
    d_med = float(torch.stack([d_ref[k] for k in moved]).median())
    bn_keys = sorted(state.bn_after)
    s_ref = {k: (trainer.w[k] - state.w[k]).norm() for k in bn_keys}
    s_mine = {k: (state.bn_after[k] - state.w[k]).norm() for k in bn_keys}
    s_med = float(torch.stack([s_ref[k] for k in bn_keys]).median())
    lim = {k: v["limit"] for k, v in cell.limits.items()}
    return [("piece_mismatch", mismatched, lim["piece_mismatch"]),
            ("embed_gap", embed_gap, lim["embed_gap"]),
            ("loss_gap", max(abs(a - b) / abs(b)
                             for a, b in zip(state.losses, losses)),
             lim["loss_gap"]),
            ("grad_gap", plain._gap(g_mine, g_ref, keys, g_med),
             lim["grad_gap"]),
            ("change_gap", plain._gap(d_mine, d_ref, moved, d_med),
             lim["change_gap"]),
            ("bn_gap", plain._gap(s_mine, s_ref, bn_keys, s_med),
             lim["bn_gap"])]
