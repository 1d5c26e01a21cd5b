"""Shared training machinery: losses, the optimizer, the loss drain
(port of ``icd_tpu/training/common.py:31-182`` and
``icd_tpu/training/baseline.py:156-163``).

Numerical conventions follow the reference exactly:
 - cross-entropy = torch ``nn.CrossEntropyLoss`` (mean over the
   positions within each row's decode length); the attention driver's
   decode lengths are uniform, so it counts every position of the
   padded decode window (models/attention.py:399-411)
 - gradient clipping is elementwise value clamping to +/-grad_clip
   before the Adam step (train_utils.py:2-12)
 - Adam uses torch defaults (b1=0.9, b2=0.999, eps=1e-8). optax's
   ``adam`` and ``torch.optim.Adam`` compute the same update, eps added
   after the bias-corrected square root; the port runs torch's
   ``foreach`` implementation on both devices.

Frozen parameters carry ``requires_grad=False`` and a frozen module runs
under ``torch.no_grad()``, so autograd never builds its backward, as the
JAX package's ``partition`` keeps XLA from building it.
"""

import time

import torch
import torch.nn.functional as F


class LossDrain:
    """Blocked loss fetcher for the per-batch-loss train loops
    (common.py:31).

    The reference records (and prints) a loss for every batch
    (models/baseline.py:245-258). Fetching each scalar makes the host
    wait for the card every step; the drain keeps the per-batch loss
    values and print lines unchanged while fetching ``BLOCK`` losses
    with one synchronisation (``torch.stack(...).tolist()``).

    The per-batch "Time:" column is the dispatch-to-dispatch interval
    (host pacing). The wait of each block's fetch lands in the next
    batch's interval, so printed times oscillate around the true mean;
    the loss values are exact.
    """

    BLOCK = 16  # losses fetched per synchronisation

    def __init__(self, finish):
        self.finish = finish  # finish(loss_val, batch_idx, dt_seconds)
        self._pending = []  # [(device_loss, batch_idx, dispatch_t)]
        self._last_t = time.time()

    def push(self, device_loss, batch_idx):
        now = time.time()
        self._pending.append((device_loss, batch_idx, now - self._last_t))
        self._last_t = now
        if len(self._pending) >= self.BLOCK:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        vals = torch.stack([p[0] for p in self._pending]).tolist()
        for val, (_, batch_idx, dt) in zip(vals, self._pending):
            self.finish(float(val), batch_idx, dt)
        self._pending = []


def token_nll(logits, targets, decode_lengths):
    """-log softmax(logits)[target] per position (B, T), in f32, zero
    past each row's decode length."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, targets[..., None].long())[..., 0]
    steps = torch.arange(targets.shape[1], device=targets.device)
    return torch.where(steps[None, :] < decode_lengths[:, None], nll, 0.0)


def cross_entropy(logits, targets, decode_lengths):
    """torch CrossEntropyLoss over the positions within each row's decode
    length (common.py:144): the mean of ``token_nll`` over them, as
    pack_padded over the decode lengths gives it (attention.py:100-117).
    """
    nll = token_nll(logits, targets, decode_lengths)
    return nll.sum() / decode_lengths.sum().clamp(min=1)


def doubly_stochastic_regularizer(alphas, alpha_c):
    """((alpha_c - sum_t alpha)^2).mean() (reference: attention.py:413-414)."""
    return ((alpha_c - alphas.sum(dim=1)) ** 2).mean()


def make_optimizer(encoder_params, decoder_params, encoder_lr, decoder_lr):
    """Adam with torch's defaults over two parameter groups, the
    per-module rates of ``make_optimizer_for`` (baseline.py:156-163). A
    group may be empty: the attention model's encoder trains nothing."""
    return torch.optim.Adam(
        [{"params": list(encoder_params), "lr": encoder_lr},
         {"params": list(decoder_params), "lr": decoder_lr}],
        betas=(0.9, 0.999), eps=1e-8, foreach=True)


def clip_gradients(optimizer, grad_clip):
    """Clamp every gradient the optimizer will apply to +/-grad_clip
    (common.py:172; None: no clipping)."""
    if grad_clip is not None:
        torch.nn.utils.clip_grad_value_(
            [p for group in optimizer.param_groups for p in group["params"]],
            grad_clip)
