"""The attention captioner's training step as the reference trains it
(models/attention.py:287-452, train.py's defaults): the frozen
ResNet-101 in train-mode BN gives the grid, the decoder's loss with
dropout, gradients of the decoder's trained leaves (every leaf but the
embedding table), each clamped to +-grad_clip, and Adam (Kingma and Ba
2015; PyTorch's defaults b1 0.9, b2 0.999, eps 1e-8 added after the
bias-corrected square root). Written out, float32."""

import torch

from . import attention, resnet


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def trained(name):
    return name.startswith("decoder.") and name != "decoder.embedding.weight"


class Trainer:
    """``step(imgs, captions, keep)`` on a copy of the weights ``w``:
    returns the loss and the clamped gradients it applied."""

    def __init__(self, w, cfg):
        self.cfg = cfg
        self.w = {k: t.detach().clone() for k, t in w.items()}
        self.params = {k: t for k, t in self.w.items() if trained(k)}
        self.adam = Adam(self.params, cfg["decoder_lr"])

    def step(self, imgs, captions, keep):
        cfg = self.cfg
        with torch.no_grad():
            grid, new_stats = resnet.grid(self.w, imgs, cfg["resnet_depths"],
                                          cfg["grid"], mode="train")
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        w = dict(self.w, **leaves)
        loss = attention.train_loss(w, grid, captions, keep, cfg["dropout"],
                                    cfg["alpha_c"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        clip = cfg["grad_clip"]
        grads = {k: g.clamp(-clip, clip) for k, g in zip(leaves, grads)}
        self.adam.step(self.params, grads)
        with torch.no_grad():
            for k, t in new_stats.items():
                self.w[k].copy_(t)
        return loss.detach(), grads
