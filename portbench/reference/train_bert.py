"""The attention captioner's training step on BERT's caption embeddings,
as the reference trains ``make attention_bert`` (``--use_bert
--fine_tune_embedding --embed_size 768``; models/attention.py:242-247,
287-452): ``train.Trainer``'s step with the decoder reading, at step t,
row t of the caption's aligned embeddings (``bert.Embedder``: row 0 is
``[CLS]``, row t word t - 1) in place of its table. The table is not
trained: its gradient is None on this path, so Adam leaves it. float32,
written out; the decoder's cell is ``attention.Decoder``'s."""

import torch
import torch.nn.functional as F

from . import attention, resnet, train


def train_loss(w, grid, captions, embeddings, keep, dropout, alpha_c):
    """``attention.train_loss`` with step t fed ``embeddings[:, t]``."""
    dec = attention.Decoder(w, grid)
    h, c = dec.h0, dec.c0
    logits, alphas = [], []
    for t in range(captions.shape[1] - 1):
        h, c, alpha = dec.step(embeddings[:, t], h, c)
        dropped = torch.where(keep[:, t], h / (1.0 - dropout), 0.0)
        logits.append(dec.logits(dropped))
        alphas.append(alpha)
    logits = torch.stack(logits, dim=1)
    ce = F.cross_entropy(logits.flatten(0, 1), captions[:, 1:].flatten())
    reg = ((alpha_c - torch.stack(alphas, dim=1).sum(dim=1)) ** 2).mean()
    return ce + reg


class Trainer(train.Trainer):
    """``step(imgs, captions, keep, embeddings)`` on a copy of ``w``:
    returns the loss and the clamped gradients it applied."""

    def step(self, imgs, captions, keep, embeddings):
        cfg = self.cfg
        with torch.no_grad():
            grid, new_stats = resnet.grid(self.w, imgs, cfg["resnet_depths"],
                                          cfg["grid"], mode="train")
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        w = dict(self.w, **leaves)
        loss = train_loss(w, grid, captions, embeddings, keep,
                          cfg["dropout"], cfg["alpha_c"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        clip = cfg["grad_clip"]
        grads = {k: g.clamp(-clip, clip) for k, g in zip(leaves, grads)}
        self.adam.step(self.params, grads)
        with torch.no_grad():
            for k, t in new_stats.items():
                self.w[k].copy_(t)
        return loss.detach(), grads
