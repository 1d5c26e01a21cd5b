"""Training of the soft-attention captioner as the train CLI runs it by
default: ``icd_tpu_torch.training.common.train_epoch`` over
``training.attention.batch_step(make_train_step(...))``, fed by
``training.common.stage_batches`` from an in-memory loader; float32 with
TF32 off, the encoder frozen (train-mode BN), dropout from a generator
on the device, value clipping and Adam over the decoder
(``training.common.make_adam``).

Set-up builds the one train step and drives it through its first three
steps, each a ``train_epoch`` call of one batch, every batch a
different set of rows; then the warm-up steps; then the window trains
the same object. The check follows those first three steps in the plain
reference (the same weights, batches and dropout draws) and compares:

- ``loss_gap``: the widest relative gap of the three steps' losses;
- ``grad_gap``: the first step's clamped gradient as Adam received it
  (its first moment after one step over 1 - b1), leaf by leaf, by the
  gap of the norms over the reference's norm of the leaf or of the
  median leaf, whichever is larger; the worst leaf;
- ``change_gap``: the parameters' change over the three steps, read
  before the fourth, by the same measure, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's
  (a leaf with none, as the attention score's bias under the softmax,
  moves under Adam by round-off alone);
- ``bn_gap``: the change of the frozen trunk's BN running statistics
  (each BN's mean and variance a leaf) over the three steps, by the
  same measure over every leaf.

The control (variant ``control``): the reference's step with TF32 on
in the program's place, the step below the configuration's float32.
"""

import sys
import time
import types

import torch

from .. import traffic as gen, weights as W
from ..counts import peaks, serve as cs, train as ct
from ..reference import exact_f32, train as ref_train

CHECKED_STEPS = 3
BETA1 = 0.9


class _Program:
    """The program's train step and what the check reads from it."""

    def __init__(self, cell, w, dropout_seed):
        from icd_tpu_torch.models.attention import AttentionDecoder
        from icd_tpu_torch.models.encoder import EncoderAttention
        from icd_tpu_torch.models.resnet import ResNet
        from icd_tpu_torch.training.attention import (batch_step,
                                                      make_train_step)
        from icd_tpu_torch.training.common import make_adam
        from icd_tpu_torch.device import use_exact_f32

        cfg, dev = cell.config, cell.device
        d = W.encoder_dim(cfg)
        with torch.device("meta"):
            resnet = ResNet(cfg["resnet_depths"], cfg["resnet_widths"])
            decoder = AttentionDecoder(cfg["vocab_size"], cfg["attention_dim"],
                                       cfg["decoder_dim"], cfg["embed_size"],
                                       d)
        self.encoder = EncoderAttention(W.load(resnet, w, "resnet."))
        self.decoder = W.load(decoder, w, "decoder.")
        args = types.SimpleNamespace(
            fine_tune_embedding=False, use_bert=False,
            encoder_lr=cfg["encoder_lr"], decoder_lr=cfg["decoder_lr"])
        use_exact_f32()
        self.optimizer = make_adam(args, self.encoder, self.decoder, None)
        step = make_train_step(self.encoder, self.decoder, self.optimizer,
                               cfg["alpha_c"], cfg["dropout"],
                               cfg["grad_clip"])
        if cell.fault is not None:
            step = cell.fault(step, self)
        generator = torch.Generator(dev).manual_seed(dropout_seed)
        self.run = batch_step(step, dev, generator)

    def trained(self):
        return {"decoder." + k: p for k, p in self.decoder.named_parameters()
                if p.requires_grad}

    def first_gradient(self):
        return {k: self.optimizer.state[p]["exp_avg"] / (1 - BETA1)
                for k, p in self.trained().items()}

    def bn_stats(self):
        return {"resnet." + k: t
                for k, t in self.encoder.resnet.state_dict().items()
                if _is_bn_stat(k)}


class _Control:
    """The reference with TF32 on, as the program."""

    def __init__(self, cell, w, dropout_seed):
        cfg, dev = cell.config, cell.device
        self.trainer = ref_train.Trainer(w, cfg)
        self.generator = torch.Generator(dev).manual_seed(dropout_seed)
        self.cfg, self.device, self.grads = cfg, dev, []

    def run(self, batch):
        exact_f32(tf32=True)
        imgs = torch.as_tensor(batch["imgs"]).to(self.device)
        caps = torch.as_tensor(batch["captions"]).to(self.device)
        loss, grads = self.trainer.step(imgs, caps, _keep(
            self.generator, caps, self.cfg, self.device))
        if not self.grads:
            self.grads.append(grads)
        return loss

    def trained(self):
        return self.trainer.params

    def first_gradient(self):
        return self.grads[0]

    def bn_stats(self):
        return {k: t for k, t in self.trainer.w.items()
                if k.startswith("resnet.") and _is_bn_stat(k)}


def _is_bn_stat(name):
    return name.endswith((".mean", ".var"))


def _keep(generator, caps, cfg, device):
    """Dropout's keep mask of a step, drawn as the program draws it."""
    b, t = caps.shape
    return torch.rand((b, t - 1, cfg["decoder_dim"]), generator=generator,
                      device=device) < 1.0 - cfg["dropout"]


def _epoch(state, batches):
    from icd_tpu_torch.training.common import stage_batches, train_epoch

    return train_epoch(state.program.run,
                       stage_batches(batches, state.cell.device),
                       num_batches=0, verbose=False)


def build(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    state = types.SimpleNamespace(cell=cell)
    state.batches = gen.train_batches(tr, cfg, cell.seed)
    cell.mark("inputs")
    state.w = W.make(cfg, gen.torch_seed(cell.seed, "weights"), dev)
    state.dropout_seed = gen.torch_seed(cell.seed, "dropout")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cell.mark("weights")
    kind = _Control if cell.variant == "control" else _Program
    state.program = kind(cell, state.w, state.dropout_seed)
    cell.mark("program")

    state.losses = []
    for s in range(CHECKED_STEPS):
        state.losses += _epoch(state, state.batches[s:s + 1])
        if s == 0:
            state.grad1 = {k: g.detach().clone()
                           for k, g in state.program.first_gradient().items()}
    state.after = {k: p.detach().clone()
                   for k, p in state.program.trained().items()}
    state.bn_after = {k: t.detach().clone()
                      for k, t in state.program.bn_stats().items()}
    cell.mark("checked steps")
    state.next = CHECKED_STEPS + tr["warmup_steps"]
    _epoch(state, state.batches[CHECKED_STEPS:state.next])

    b = tr["batch"]
    enc = b * cs.resnet_gflop(cfg["resnet_depths"], cfg["resnet_widths"],
                              tr["image_size"])
    dims = (cfg["grid"] ** 2, W.encoder_dim(cfg), cfg["attention_dim"],
            cfg["decoder_dim"], cfg["embed_size"], cfg["vocab_size"])

    def work_s(batch):
        t = batch["captions"].shape[1]
        return ((enc + ct.attention_decoder_train_gflop(b, t, *dims)) * 1e9
                / peaks.F32_FLOP_PER_S)

    state.work_s = work_s
    return state


def _cycle(state, until=None, count=None):
    """Batches of the pool from ``state.next`` on, cycled, while the clock
    is under ``until`` or ``count`` remain; each one handed out is
    recorded in ``state.fed``."""
    n = 0
    while (until is None or time.perf_counter() < until) and (
            count is None or n < count):
        batch = state.batches[state.next % len(state.batches)]
        state.next += 1
        n += 1
        state.fed.append(batch)
        yield batch


def window(state, seconds):
    b = state.cell.traffic["batch"]
    state.fed = []
    start = time.perf_counter()
    losses = _epoch(state, _cycle(state, until=start + seconds))
    length = time.perf_counter() - start
    n = len(losses)
    return {"seconds": length, "attempted": n, "failed": 0,
            "metrics": {"train_images_per_s": n * b / length},
            "counters": {"window_s": length,
                         "work_at_peak_s": sum(state.work_s(x)
                                               for x in state.fed)}}


def traced(state, tracer):
    run = state.program.run

    def spanned(batch):
        with tracer.span("step"):
            return run(batch)

    state.program.run = spanned
    state.fed = []
    with tracer.block():
        _epoch(state, _cycle(state, count=state.cell.traffic["trace_steps"]))
    state.program.run = run
    return tracer.reading({"traced_steps": len(state.fed)})


def _gap(mine, ref, keys, floor):
    return max(abs(float(mine[k]) - float(ref[k])) / max(float(ref[k]), floor)
               for k in keys)


def check(state):
    cell = state.cell
    cfg, dev = cell.config, cell.device
    state.program = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    exact_f32()
    trainer = ref_train.Trainer(state.w, cfg)
    generator = torch.Generator(dev).manual_seed(state.dropout_seed)
    losses = []
    for s in range(CHECKED_STEPS):
        imgs = gen.to_torch(state.batches[s]["imgs"], dev)
        caps = gen.to_torch(state.batches[s]["captions"], dev)
        loss, grads = trainer.step(imgs, caps,
                                   _keep(generator, caps, cfg, dev))
        losses.append(float(loss))
        if s == 0:
            grad1 = grads
    keys = sorted(grad1)
    g_ref = {k: grad1[k].norm() for k in keys}
    g_mine = {k: state.grad1[k].norm() for k in keys}
    g_med = float(torch.stack([g_ref[k] for k in keys]).median())
    d_ref = {k: (trainer.params[k] - state.w[k]).norm() for k in keys}
    d_mine = {k: (state.after[k] - state.w[k]).norm() for k in keys}
    moved = [k for k in keys if float(g_ref[k]) >= 1e-3 * g_med]
    print("portbench: change_gap leaves out {}".format(
        sorted(set(keys) - set(moved))), file=sys.stderr)
    d_med = float(torch.stack([d_ref[k] for k in moved]).median())
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(state.losses, losses))
    bn_keys = sorted(state.bn_after)
    s_ref = {k: (trainer.w[k] - state.w[k]).norm() for k in bn_keys}
    s_mine = {k: (state.bn_after[k] - state.w[k]).norm() for k in bn_keys}
    s_med = float(torch.stack([s_ref[k] for k in bn_keys]).median())
    lim = cell.limits
    return [("loss_gap", loss_gap, lim["loss_gap"]["limit"]),
            ("grad_gap", _gap(g_mine, g_ref, keys, g_med),
             lim["grad_gap"]["limit"]),
            ("change_gap", _gap(d_mine, d_ref, moved, d_med),
             lim["change_gap"]["limit"]),
            ("bn_gap", _gap(s_mine, s_ref, bn_keys, s_med),
             lim["bn_gap"]["limit"])]
