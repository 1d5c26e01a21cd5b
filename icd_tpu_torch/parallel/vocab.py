"""Vocab-parallel embedding and output projection: what XLA does for the
JAX package when ``decoder_param_specs`` shards a decoder's table (V, E)
and projection (H, V) over ``model`` on V (``icd_tpu/parallel/
mesh.py:68-84``), written out for ``torch.distributed``.

Rank m of a model group of n holds rows [m V/n, (m + 1) V/n) of the
table and of the projection's weight and bias (``nn.Linear``'s (V, H)).

- ``VocabParallelEmbedding``: the rank looks up the ids that fall in its
  rows, zero for the others, and the rows are summed over ``model``.
- ``VocabParallelLinear``: the rank computes its columns of the logits,
  x W^T + b as two operations (``models/baseline.py:VocabProjection``),
  and gathers them to the full (..., V) logits, on which the loss runs
  unchanged.

The loss is then computed whole on every model rank: it is *replicated*,
as XLA's is. The library collectives would be wrong here:
``torch.distributed.nn``'s ``all_gather`` and ``all_reduce`` sum the
gradient over the group in their backward, which for a replicated loss
hands each shard n_model times its gradient. The ``autograd.Function``s
below have the backward a replicated loss needs: the gather's takes the
rank's own columns of the gradient (no reduce-scatter); the embedding's
sum passes the gradient through (each rank's share enters the sum with
weight 1); and the projection's input, read by every rank's columns,
sums its gradient's shares over ``model``. Collectives run in f32 (bf16
values under ``--amp`` are carried exactly and summed in f32) as list
``all_gather`` and ``all_reduce``, which gloo also serves for CUDA
tensors.
"""

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.baseline import VocabProjection


def _all_reduce(x, group):
    y = x.float().contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum over ``model``. Backward: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the sum over ``model`` of each
    rank's share of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherVocab(torch.autograd.Function):
    """Forward: the ranks' column blocks gathered along the last dim, in
    model order. Backward: the rank's own block of the gradient."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.index, ctx.width = index, x.shape[-1]
        parts = [torch.empty_like(x, dtype=torch.float32)
                 for _ in range(size)]
        dist.all_gather(parts, x.float().contiguous(), group=group)
        return torch.cat(parts, dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None, None, \
            None


class VocabParallelEmbedding(nn.Module):
    """The rank's rows of an (V, E) table (``weight``), looked up and
    summed over the model group."""

    def __init__(self, weight, index, group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.start = index * weight.shape[0]
        self.group = group

    def forward(self, ids):
        local = ids - self.start
        inside = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(local.clamp(0, self.weight.shape[0] - 1),
                           self.weight)
        rows = torch.where(inside[..., None], rows, 0.0)
        return _SumOverModel.apply(rows, self.group)


class VocabParallelLinear(nn.Module):
    """The rank's rows of a (V, H) projection (``weight``, ``bias``): its
    logit columns, gathered to all V over the model group."""

    def __init__(self, weight, bias, index, size, group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.index, self.size, self.group = index, size, group

    def forward(self, x):
        x = _CopyToModel.apply(x, self.group)
        y = F.linear(x, self.weight) + self.bias
        return _GatherVocab.apply(y, self.group, self.index, self.size)


_VOCAB_MODULES = ("embedding", "fc", "linear")


def _swap(optimizer, old, new, moment):
    """Put parameter ``new`` in the place of ``old`` in ``optimizer``'s
    groups, its state tensors of ``old``'s shape passed through
    ``moment``."""
    if optimizer is None:
        return
    for group in optimizer.param_groups:
        group["params"] = [new if p is old else p for p in group["params"]]
    state = optimizer.state.pop(old, None)
    if state:
        optimizer.state[new] = {
            key: moment(v) if torch.is_tensor(v) and v.shape == old.shape
            else v for key, v in state.items()}


def shard_decoder(decoder, mesh, optimizer=None):
    """Swap ``decoder``'s ``embedding`` and ``fc`` / ``linear`` for this
    rank's vocab shards (``decoder_param_specs``) in place, and their
    Adam state in ``optimizer`` for the same rows. A model axis of 1
    leaves the decoder as it is. Returns the decoder."""
    n = mesh.shape["model"]
    if n == 1:
        return decoder
    index = mesh.coords[1]
    for name in _VOCAB_MODULES:
        module = getattr(decoder, name, None)
        if not isinstance(module, (nn.Embedding, nn.Linear)):
            continue
        vocab = module.weight.shape[0]
        if vocab % n:
            raise ValueError("a vocabulary of {} does not split over {} "
                             "model ranks".format(vocab, n))
        rows = slice(index * vocab // n, (index + 1) * vocab // n)

        def cut(t):
            return t.detach()[rows].clone()

        if isinstance(module, nn.Embedding):
            new = VocabParallelEmbedding(cut(module.weight), index,
                                         mesh.model_group)
            pairs = [(module.weight, new.weight)]
        else:
            new = VocabParallelLinear(cut(module.weight), cut(module.bias),
                                      index, n, mesh.model_group)
            pairs = [(module.weight, new.weight), (module.bias, new.bias)]
        for old, param in pairs:
            param.requires_grad_(old.requires_grad)
            _swap(optimizer, old, param, cut)
        setattr(decoder, name, new)
    return decoder


def unshard_decoder(decoder, mesh, optimizer=None):
    """The inverse of ``shard_decoder``, in place: the shards gathered
    over the model group into full ``nn.Embedding`` and
    ``VocabProjection`` modules, and their Adam state likewise. Every
    rank of the group must call it. Returns the decoder."""
    if mesh.shape["model"] == 1:
        return decoder

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=mesh.model_group)
        return torch.cat(parts)

    for name in _VOCAB_MODULES:
        module = getattr(decoder, name, None)
        if isinstance(module, VocabParallelEmbedding):
            weight = gather(module.weight)
            new = nn.Embedding(*weight.shape, _weight=weight)
            pairs = [(module.weight, new.weight)]
        elif isinstance(module, VocabParallelLinear):
            weight = gather(module.weight)
            new = VocabProjection(weight.shape[1], weight.shape[0],
                                  device=weight.device, dtype=weight.dtype)
            new.weight.data, new.bias.data = weight, gather(module.bias)
            pairs = [(module.weight, new.weight), (module.bias, new.bias)]
        else:
            continue
        for old, param in pairs:
            param.requires_grad_(old.requires_grad)
            _swap(optimizer, old, param, gather)
        setattr(decoder, name, new)
    return decoder
