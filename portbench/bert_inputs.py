"""The inputs of a configuration with a ``bert`` block
(``configs/sat-bert-resnet101.json``), made from the run's seed:

- ``caption_words``: the caption vocabulary, id -> word: ``<pad>`` 0,
  then distinct lowercase ASCII words of the configuration's
  ``caption_words.letters``, then ``<start>``, ``<end>`` and ``<unk>``
  at the ids ``traffic.train_batches`` uses (V - 3, V - 2, V - 1);
- ``write_wordpiece_vocab``: a WordPiece ``vocab.txt`` of exactly the
  BERT block's ``vocab_size`` entries in bert-base-uncased's layout:
  ``[PAD]`` 0, ``[unused*]`` slots around ``[UNK]`` (100 in
  bert-base), ``[CLS]``, ``[SEP]``, ``[MASK]``; single characters and
  the ``##`` forms of letters and digits; ``start``, ``end``, ``pad``
  and ``unk``; ``whole_share`` of the caption words as whole entries,
  each other one split into 2 or 3 pieces that the file holds; then
  filler entries that no caption can use (each holds a digit, and
  caption words hold none);
- ``make_bert``: BERT's weights as ``transformers`` initialises a
  ``BertModel`` (products and tables N(0, initializer_range), the
  ``[PAD]`` row 0, biases 0, LayerNorms 1 and 0), named as the
  program's ``BertEncoder`` names them under ``bert.``, in one normal
  draw of a generator on the run's device;
- ``fresh_captions``: a batch of the pool with new words, drawn for the
  k-th batch handed out, at the same lengths.

Each use has a stream of its own, numbered after ``traffic.STREAMS``,
so that none moves the streams the other cells draw from.
"""

import math

import numpy as np
import torch

from . import traffic as gen

USES = ("caption_words", "bert_weights", "fresh_words")
SPECIAL = ("<pad>", "<start>", "<end>", "<unk>")
# Printable ASCII without capitals (bert-base-uncased has no capital
# letters): punctuation, digits and the 26 letters.
CHARS = [chr(c) for c in range(33, 127) if not chr(c).isupper()]


def stream(seed, use, *index):
    """A numpy Generator for one ``use`` of ``seed`` (and ``index``)."""
    return np.random.default_rng(
        [len(gen.STREAMS) + USES.index(use), seed % 2 ** 64, *index])


def caption_words(cfg, seed):
    """The caption vocabulary as a list, id -> word."""
    lo, hi = cfg["caption_words"]["letters"]
    rng = stream(seed, "caption_words")
    words, seen = [], set()
    while len(words) < cfg["vocab_size"] - len(SPECIAL):
        n = int(rng.integers(lo, hi + 1))
        word = "".join(chr(97 + c) for c in rng.integers(0, 26, n))
        if word not in seen:
            seen.add(word)
            words.append(word)
    return [SPECIAL[0]] + words + list(SPECIAL[1:])


def wordpiece_entries(cfg, words, seed):
    """The ``vocab.txt`` lines for the caption vocabulary ``words``."""
    size = cfg["bert"]["vocab_size"]
    front, back = cfg["wordpiece"]["unused"]
    unused = ["[unused{}]".format(i) for i in range(front + back)]
    entries = (["[PAD]"] + unused[:front] + ["[UNK]", "[CLS]", "[SEP]",
                                             "[MASK]"] + unused[front:]
               + CHARS + ["start", "end", "pad", "unk"])
    rng = stream(seed, "caption_words", 1)
    caption = words[1:-3]
    split = rng.random(len(caption)) >= cfg["wordpiece"]["whole_share"]
    for word, cut in zip(caption, split):
        if not cut:
            entries.append(word)
            continue
        k = min(int(rng.integers(2, 4)), len(word))
        points = sorted(int(p) for p in rng.choice(
            np.arange(1, len(word)), k - 1, replace=False))
        parts = [word[a:b] for a, b in zip([0] + points,
                                           points + [len(word)])]
        entries += [parts[0]] + ["##" + p for p in parts[1:]]
    entries += ["##" + c for c in CHARS if c.isalnum()]
    entries = list(dict.fromkeys(entries))
    if len(entries) > size:
        raise ValueError("{} WordPiece entries for a vocabulary of {}"
                         .format(len(entries), size))
    return entries + ["x{:05d}".format(i) for i in range(size - len(entries))]


def write_wordpiece_vocab(path, cfg, words, seed):
    entries = wordpiece_entries(cfg, words, seed)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(entries) + "\n")
    return path


def bert_leaves(bert):
    """(name, shape, kind) of BERT's weights, the program's names."""
    v, h, f = bert["vocab_size"], bert["hidden_size"], \
        bert["intermediate_size"]
    out = [("word.weight", (v, h), "normal"),
           ("pos.weight", (bert["max_position_embeddings"], h), "normal"),
           ("token_type.weight", (bert["type_vocab_size"], h), "normal"),
           ("ln_emb.weight", (h,), "one"), ("ln_emb.bias", (h,), "zero")]
    for layer in range(bert["num_hidden_layers"]):
        q = "layers.{}.".format(layer)
        for name in ("q", "k", "v", "o"):
            out += [(q + name + ".weight", (h, h), "normal"),
                    (q + name + ".bias", (h,), "zero")]
        out += [(q + "ln_att.weight", (h,), "one"),
                (q + "ln_att.bias", (h,), "zero"),
                (q + "ffn_in.weight", (f, h), "normal"),
                (q + "ffn_in.bias", (f,), "zero"),
                (q + "ffn_out.weight", (h, f), "normal"),
                (q + "ffn_out.bias", (h,), "zero"),
                (q + "ln_out.weight", (h,), "one"),
                (q + "ln_out.bias", (h,), "zero")]
    return out


@torch.no_grad()
def make_bert(bert, seed, device):
    """{``bert.<name>``: float32 tensor on ``device``} from ``seed``."""
    specs = bert_leaves(bert)
    g = torch.Generator(device=device).manual_seed(
        int(stream(seed, "bert_weights").integers(0, 2 ** 63 - 1)))
    total = sum(math.prod(s) for _, s, k in specs if k == "normal")
    pool = torch.randn(total, generator=g, device=device)
    pool *= bert["initializer_range"]
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "normal":
            n = math.prod(shape)
            out["bert." + name] = pool[at:at + n].view(shape)
            at += n
        else:
            out["bert." + name] = torch.full(
                shape, 1.0 if kind == "one" else 0.0, device=device)
    out["bert.word.weight"][0] = 0.0  # [PAD]
    return out


def fresh_captions(batch, vocab_size, seed, k):
    """``batch`` with the words of its captions drawn anew for the k-th
    batch handed out (ids 1 .. V - 4, uniform), ``<start>``, ``<end>``,
    the padding and the lengths as they were."""
    caps = batch["captions"].copy()
    words = batch["caption_lengths"] - 2
    cols = np.arange(caps.shape[1])[None, :]
    mask = (cols >= 1) & (cols < 1 + words[:, None])
    caps[mask] = stream(seed, "fresh_words", k).integers(
        1, vocab_size - 3, int(mask.sum()))
    return dict(batch, captions=caps)
