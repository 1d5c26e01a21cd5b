"""BERT's caption embeddings as the reference makes them
(models/attention.py:96-100, 166-215, with pytorch-pretrained-bert's
``BertTokenizer`` and ``BertModel`` of bert-base-uncased, Devlin et al.
2019, arXiv:1810.04805), written out in float32:

- the caption's ids become words (``<start>``, ``<end>`` and ``<pad>``
  as those literal words), joined by spaces after ``[CLS]``;
- ``BasicTokenizer`` (control characters dropped, whitespace split,
  each word but the special tokens lower-cased, accents stripped and
  split at punctuation; the CJK spacing is left out, since the captions
  are ASCII) and ``WordpieceTokenizer`` (greedy longest match first,
  ``##`` continuations, ``[UNK]`` for a word it cannot cover or of more
  than 100 characters);
- BERT's forward on the caption alone, with no padding and no mask:
  word + position + token-type embeddings, LayerNorm, then per layer
  self-attention, the output product, a residual LayerNorm, the erf
  GeLU feed-forward and another residual LayerNorm; the last layer's
  hidden states;
- the alignment walk (attention.py:185-209): the whitespace words (with
  ``[CLS]``) in order, each taking the next piece when it is the word
  whole, else pieces until their concatenation without ``#`` is the
  word; each word's pieces summed, ``[CLS]`` kept as row 0.

Departures: the walk stops at the last piece where the reference's
would index past it (a word its pieces never spell, which ASCII
captions without ``[UNK]`` do not have), and a word that takes no
piece gets a zero row. Weights are read from a dict by the names
``bert.word.weight`` ... ``bert.layers.<i>.ln_out.bias``.
"""

import math
import unicodedata

import torch

NEVER_SPLIT = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def load_vocab(path):
    """``vocab.txt`` -> {piece: line number}."""
    with open(path, encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def _punctuation(char):
    cp = ord(char)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(char).startswith("P")


def basic_tokens(text):
    out = []
    clean = "".join(" " if ch in " \t\n\r" or unicodedata.category(ch) == "Zs"
                    else ch for ch in text
                    if ord(ch) not in (0, 0xFFFD)
                    and not (unicodedata.category(ch).startswith("C")
                             and ch not in "\t\n\r"))
    for token in clean.split():
        if token in NEVER_SPLIT:
            out.append(token)
            continue
        token = "".join(ch for ch in unicodedata.normalize("NFD",
                                                           token.lower())
                        if unicodedata.category(ch) != "Mn")
        word = ""
        for ch in token:
            if _punctuation(ch):
                if word:
                    out.append(word)
                out.append(ch)
                word = ""
            else:
                word += ch
        if word:
            out.append(word)
    return out


def wordpieces(word, vocab):
    if len(word) > 100:
        return ["[UNK]"]
    out, start = [], 0
    while start < len(word):
        end = len(word)
        while end > start:
            piece = ("##" if start else "") + word[start:end]
            if piece in vocab:
                break
            end -= 1
        else:
            return ["[UNK]"]
        out.append(piece)
        start = end
    return out


class Tokenizer:
    def __init__(self, path):
        self.vocab = load_vocab(path)

    def tokenize(self, text):
        return [p for w in basic_tokens(text) for p in wordpieces(w,
                                                                 self.vocab)]

    def ids(self, pieces):
        return [self.vocab[p] for p in pieces]


def walk(words, pieces):
    """For each word, the indices of the pieces summed into it."""
    out, j = [], 0
    for word in words:
        built, taken = "", []
        for i in range(len(pieces) - 1):
            if i + j >= len(pieces):
                break
            piece = pieces[i + j]
            if piece == word and not built:
                taken = [i + j]
                j += 1
                break
            taken.append(i + j)
            built += piece.replace("#", "")
            if built == word:
                j += len(taken)
                break
        out.append(taken)
    return out


def _layer_norm(x, w, name, eps):
    u = x.mean(-1, keepdim=True)
    s = (x - u).pow(2).mean(-1, keepdim=True)
    return w[name + ".weight"] * ((x - u) / torch.sqrt(s + eps)) \
        + w[name + ".bias"]


def _lin(x, w, name):
    return x @ w[name + ".weight"].t() + w[name + ".bias"]


def _gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def forward(w, ids, cfg, prefix="bert."):
    """(n,) piece ids of one caption -> (n, H) last hidden states."""
    p, eps = prefix, cfg["layer_norm_eps"]
    n, heads = len(ids), cfg["num_attention_heads"]
    x = (w[p + "word.weight"][ids] + w[p + "pos.weight"][:n]
         + w[p + "token_type.weight"][0])
    x = _layer_norm(x, w, p + "ln_emb", eps)
    d = x.shape[1] // heads
    for layer in range(cfg["num_hidden_layers"]):
        q = "{}layers.{}.".format(p, layer)
        qs, ks, vs = (_lin(x, w, q + name).view(n, heads, d).transpose(0, 1)
                      for name in ("q", "k", "v"))
        probs = torch.softmax(qs @ ks.transpose(1, 2) / math.sqrt(d), dim=-1)
        ctx = (probs @ vs).transpose(0, 1).reshape(n, heads * d)
        x = _layer_norm(x + _lin(ctx, w, q + "o"), w, q + "ln_att", eps)
        inter = _gelu(_lin(x, w, q + "ffn_in"))
        x = _layer_norm(x + _lin(inter, w, q + "ffn_out"), w, q + "ln_out",
                        eps)
    return x


class Embedder:
    """The captions' aligned embeddings: ``pieces(captions)`` gives each
    row's (piece ids, word index of each piece, -1 for none), and
    ``__call__(captions)`` (B, T) -> (B, T + 1, H) on the weights'
    device, one caption at a time."""

    def __init__(self, w, cfg, vocab_path, words):
        self.w, self.cfg, self.words = w, cfg, words
        self.tokenizer = Tokenizer(vocab_path)

    def _row(self, caption):
        words = ["[CLS]"] + [self.words[int(t)] for t in caption]
        text = " ".join(words)
        pieces = self.tokenizer.tokenize(text)
        return text.split(), pieces, walk(text.split(), pieces)

    def pieces(self, captions):
        out = []
        for caption in captions:
            _, pieces, groups = self._row(caption)
            seg = [-1] * len(pieces)
            for i, group in enumerate(groups):
                for k in group:
                    seg[k] = i
            out.append((self.tokenizer.ids(pieces), seg))
        return out

    @torch.no_grad()
    def __call__(self, captions):
        device = self.w["bert.word.weight"].device
        rows = []
        for caption in captions:
            words, pieces, groups = self._row(caption)
            ids = torch.tensor(self.tokenizer.ids(pieces), device=device)
            hidden = forward(self.w, ids, self.cfg)
            rows.append(torch.stack([
                hidden[group].sum(0) if group else hidden.new_zeros(
                    hidden.shape[1]) for group in groups]))
        return torch.stack(rows)
