"""The BERT encoder forward (port of ``icd_tpu/models/bert_jax.py``).

Frozen bert-base, run to give teacher forcing its caption embeddings
(``models/bert_embed.py``): word + position + token-type embeddings, a
LayerNorm at the config's eps, then per layer scaled dot-product
attention written out (``matmul``, the additive -1e9 padding mask,
softmax, ``matmul``), the output product, a post-LN residual, the erf
GeLU feed-forward and another post-LN residual (bert_jax.py:121-164).
The piece -> word alignment sums each word's pieces with ``index_add_``
(bert_jax.py:167-187).

``quantize_bert`` makes the W8A8 variant (bert_jax.py:77-118): every
Linear's weight per-output-channel int8 (``ops/qlinear.py``), its
activations quantized per row at each product; the attention's own
products, the embeddings and the LayerNorms stay f32.

The JAX package pads lengths and word counts to buckets of 16 so that
XLA compiles few programs (bert_jax.py:221-261); eager PyTorch compiles
none, so ``TorchBert`` runs every batch at its own length, unless
``TorchBert.capture`` has made CUDA graphs of the float forward: a batch
whose rows and length bucket (``LENGTH_BUCKET``, the JAX package's 16)
have a graph is padded to the bucket and issued as one replay instead
of a launch for each of its ~330 operations. Padded keys change no valid
row: their scores sit at -1e9, whose exponential is an exact 0 in f32.
"""

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.pipeline import to_device
from ..ops.qlinear import qmatmul, quantize_linear
from ..utils.profiling import annotate

# The lengths a captured forward runs at are multiples of this (the JAX
# package's bucket, bert_jax.py:221).
LENGTH_BUCKET = 16

# bert-base-uncased's geometry (its config.json).
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12)


class BertLayer(nn.Module):
    """One encoder layer, its parts named as the JAX tree names them."""

    def __init__(self, hidden, intermediate, eps):
        super().__init__()
        self.q, self.k, self.v, self.o = (nn.Linear(hidden, hidden)
                                          for _ in range(4))
        self.ln_att = nn.LayerNorm(hidden, eps=eps)
        self.ffn_in = nn.Linear(hidden, intermediate)
        self.ffn_out = nn.Linear(intermediate, hidden)
        self.ln_out = nn.LayerNorm(hidden, eps=eps)


class BertEncoder(nn.Module):
    """bert's embeddings and encoder layers (no pooler); the JAX tree's
    ``type`` table is ``token_type`` here (``Module.type`` is a method)."""

    def __init__(self, vocab_size, hidden_size, num_hidden_layers,
                 num_attention_heads, intermediate_size,
                 max_position_embeddings, type_vocab_size=2,
                 layer_norm_eps=1e-12):
        super().__init__()
        self.num_heads = num_attention_heads
        self.word = nn.Embedding(vocab_size, hidden_size)
        self.pos = nn.Embedding(max_position_embeddings, hidden_size)
        self.token_type = nn.Embedding(type_vocab_size, hidden_size)
        self.ln_emb = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.layers = nn.ModuleList(
            BertLayer(hidden_size, intermediate_size, layer_norm_eps)
            for _ in range(num_hidden_layers))

    @classmethod
    def from_config(cls, config, device=None):
        """Uninitialised weights on ``device`` for a ``config.json``
        dict."""
        keys = ("vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size",
                "max_position_embeddings")
        kw = {k: int(config[k]) for k in keys}
        kw["type_vocab_size"] = int(config.get("type_vocab_size", 2))
        kw["layer_norm_eps"] = float(config.get("layer_norm_eps", 1e-12))
        with torch.device("meta"):
            bert = cls(**kw)
        return bert.to_empty(device=device or "cpu")


def init_bert(generator, config=BERT_BASE, device=None):
    """A random ``BertEncoder`` as ``transformers`` initialises one
    (products and embeddings N(0, 0.02), the [PAD] row 0, biases 0,
    LayerNorms 1 and 0), drawn from ``generator`` (CPU), on ``device``."""
    bert = BertEncoder.from_config(config, "cpu")
    with torch.no_grad():
        for name, p in bert.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith("ln_") or ".ln_" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        bert.word.weight[0] = 0.0
    return bert.eval().requires_grad_(False).to(device)


class QLinear(nn.Module):
    """A Linear of the W8A8 BERT: ``wq`` (in, out) int8 (column-major,
    ``ops/qlinear.py``), ``ws`` (out,) f32 and the f32 bias ``b``."""

    def __init__(self, wq, ws, b):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("ws", ws)
        self.register_buffer("b", b)


def quantize_bert(bert):
    """A copy of ``bert`` whose Linears are W8A8 ``QLinear``s
    (bert_jax.py:77)."""
    out = copy.deepcopy(bert)
    for layer in out.layers:
        for name in ("q", "k", "v", "o", "ffn_in", "ffn_out"):
            lin = getattr(layer, name)
            wq, ws = quantize_linear(lin.weight.detach().t())
            setattr(layer, name, QLinear(wq, ws, lin.bias.detach().float()))
    return out


def _apply_lin(x, lin):
    """x @ w + b, in f32 or W8A8 (bert_jax.py:121)."""
    if isinstance(lin, QLinear):
        flat = x.reshape(-1, x.shape[-1])
        out = qmatmul(flat, lin.wq, lin.ws) + lin.b
        return out.reshape(x.shape[:-1] + (out.shape[-1],))
    return F.linear(x, lin.weight, lin.bias)


def _layer_norm(x, ln):
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def bert_encoder_forward(bert, input_ids, attention_mask):
    """(B, L) ids + (B, L) {0, 1} mask -> (B, L, H) last hidden states
    (bert_jax.py:131)."""
    b, length = input_ids.shape
    input_ids = input_ids.long()
    hidden = (F.embedding(input_ids, bert.word.weight)
              + bert.pos.weight[:length][None] + bert.token_type.weight[0])
    hidden = _layer_norm(hidden, bert.ln_emb)

    # Additive mask: padded keys pushed to -1e9 before the softmax.
    bias = (1.0 - attention_mask.to(hidden.dtype))[:, None, None, :] * -1e9
    h_dim = hidden.shape[-1]
    head_dim = h_dim // bert.num_heads
    scale = 1.0 / math.sqrt(head_dim)

    def heads(x):  # (B, L, H) -> (B, heads, L, head_dim)
        return x.reshape(b, length, bert.num_heads, head_dim).transpose(1, 2)

    for layer in bert.layers:
        q = heads(_apply_lin(hidden, layer.q))
        k = heads(_apply_lin(hidden, layer.k))
        v = heads(_apply_lin(hidden, layer.v))
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, length, h_dim)
        hidden = _layer_norm(hidden + _apply_lin(ctx, layer.o), layer.ln_att)
        inter = F.gelu(_apply_lin(hidden, layer.ffn_in), approximate="none")
        hidden = _layer_norm(hidden + _apply_lin(inter, layer.ffn_out),
                             layer.ln_out)
    return hidden


def bert_aligned_forward(bert, input_ids, attention_mask, seg, n_words):
    """The forward, then each word's pieces summed (``aligned_sum``)."""
    return aligned_sum(bert_encoder_forward(bert, input_ids, attention_mask),
                       seg, n_words)


def aligned_sum(hidden, seg, n_words):
    """(B, L, H) hidden states -> (B, n_words, H), each word's pieces
    summed (bert_jax.py:167): ``seg`` (B, L) is the word index of each
    piece, -1 for pieces no word takes (padding too), which go to a dump
    row that is cut off. Words that take no piece stay zero."""
    b, length, h_dim = hidden.shape
    seg = seg.long()
    safe = torch.where(seg < 0, n_words, seg)
    rows = safe + torch.arange(b, device=seg.device)[:, None] * (n_words + 1)
    out = hidden.new_zeros(b * (n_words + 1), h_dim)
    out.index_add_(0, rows.reshape(-1), hidden.reshape(-1, h_dim))
    return out.view(b, n_words + 1, h_dim)[:, :n_words]


def length_bucket(length):
    """The captured length a batch of ``length`` pieces runs at."""
    return -(-length // LENGTH_BUCKET) * LENGTH_BUCKET


def pad_pieces(ids, mask, seg, length):
    """(B, L) host arrays padded to ``length`` columns: ids 0 ([PAD]),
    mask 0 and seg -1, which change no valid row and no word's sum."""
    pad = ((0, 0), (0, length - ids.shape[1]))
    return (np.pad(ids, pad), np.pad(mask, pad),
            np.pad(seg, pad, constant_values=-1))


class TorchBert:
    """The BERT forward on ``device`` (``JaxBert``, bert_jax.py:190):
    ``aligned`` gives the piece -> word sums as a tensor on ``device``,
    ready for the train step. With ``int8`` the Linears are W8A8
    (``quantize_bert``). After ``capture`` a batch whose rows and length
    bucket have a CUDA graph replays it."""

    def __init__(self, bert, device=None, int8=False):
        bert = bert.eval().requires_grad_(False)
        if int8:
            bert = quantize_bert(bert)
        self.device = torch.device(device or "cpu")
        self.bert = bert.to(self.device)
        self.int8 = int8
        # (rows, padded length) -> (ids, mask, hidden, graph): the
        # graph's input buffers, its output and the graph.
        self._graphs = {}

    @torch.no_grad()
    def capture(self, rows, max_length=None):
        """CUDA graphs of the float forward of ``rows`` captions at every
        length bucket up to ``max_length`` pieces (the model's positions
        by default), captured on a side stream into one memory pool.
        They may share it because one thread replays them on one
        stream, and each replay's output is summed into words before the
        next replay is issued. Nothing on the CPU or with W8A8. Returns
        how many graphs are held."""
        if self.device.type != "cuda" or self.int8:
            return 0
        top = min(max_length or self.bert.pos.num_embeddings,
                  self.bert.pos.num_embeddings)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for length in range(LENGTH_BUCKET, length_bucket(top) + 1,
                                LENGTH_BUCKET):
                if (rows, length) in self._graphs:
                    continue
                ids = torch.zeros((rows, length), dtype=torch.int64,
                                  device=self.device)
                mask = torch.ones_like(ids)
                if not self._graphs:  # cuBLAS's state for this stream
                    bert_encoder_forward(self.bert, ids, mask)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    hidden = bert_encoder_forward(self.bert, ids, mask)
                finally:
                    graph.capture_end()
                self._graphs[(rows, length)] = (ids, mask, hidden, graph)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return len(self._graphs)

    @torch.no_grad()
    def aligned(self, ids, mask, seg, n_words):
        """(B, L) ids, mask and seg (numpy) -> (B, n_words, H) tensor on
        the device; under a profiler the span ``bert_forward``."""
        with annotate("bert_forward"):
            captured = self._graphs.get((len(ids),
                                         length_bucket(ids.shape[1])))
            if captured is None:
                return bert_aligned_forward(
                    self.bert, self._tensor(ids), self._tensor(mask),
                    self._tensor(seg), int(n_words))
            static_ids, static_mask, hidden, graph = captured
            ids, mask, seg = pad_pieces(ids, mask, seg, hidden.shape[1])
            for static, a in ((static_ids, ids), (static_mask, mask)):
                static.copy_(torch.from_numpy(a.astype(np.int64))
                             .pin_memory(), non_blocking=True)
            graph.replay()
            return aligned_sum(hidden, self._tensor(seg), int(n_words))

    def _tensor(self, a):
        return to_device(np.asarray(a, np.int64), self.device)
