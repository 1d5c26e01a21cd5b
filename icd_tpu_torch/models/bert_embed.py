"""BERT contextual caption embeddings (port of
``icd_tpu/models/bert_embed.py``; reference: models/attention.py:96-100,
166-215).

Captions are detokenized from vocab ids (special tokens appear as
literal '<start>'/'<end>'/'<pad>' words), prefixed with '[CLS]',
wordpiece-tokenized, run through bert-base in eval mode, and the final
hidden layer is re-aligned to whole vocab words by **summing** the piece
embeddings of each word.

Two reference quirks are kept because parity depends on them:
 - the '[CLS]' token is included in the aligned output, so row t holds
   the contextual embedding of word t-1 (attention.py:190-196)
 - alignment sums piece embeddings rather than averaging
   (attention.py:205)

The host does the string work (tokenization, the piece -> word walk)
and caches it per caption; the forward and the piece -> word sum run on
``device`` (``TorchBert``, the card unless the caller asks for the CPU),
which gives the embeddings as a tensor there. The JAX package also keeps
a host path (a torch forward on the CPU and a numpy alignment) for its
batch-1 eval parity under XLA's static shapes; eager PyTorch runs every
batch at its own length and padded keys change no valid row
(``models/bert.py``), so the port needs only this one path, in training
and in eval. ``TorchBert.capture`` makes CUDA graphs of the forward for
a batch size, which the batches of that size then replay. The
tokenizer is the port's own (``bert_tokenize.py``) and the weights come
from a ``save_pretrained`` directory (``bert_load.py``).

Under a profiler the host string work and the padded arrays are a span
``bert_tokenize`` and the forward (``TorchBert.aligned``) a span
``bert_forward``, on the calling thread; ``counts`` keeps how many
captions were embedded, how many of them the caption cache held, and
their pieces, padded (rows x the longest) and their own.
"""

import os

import numpy as np

from ..device import resolve_device
from ..utils.profiling import annotate
from .bert import TorchBert


def piece_word_segments(words, pieces):
    """The alignment walk of the reference as indices only
    (bert_embed.py:31): each word takes pieces until their concatenation
    (``#`` removed, lower-cased) is the word, or an ``[UNK]``.

    Degradation note: if a word's
    wordpieces never reconcatenate to the word (wordpiece NORMALIZES,
    e.g. accent-stripped 'cafe' vs target 'café'), the walk consumes
    all remaining pieces into that word and later words read zero rows.
    The reference degrades differently (its walk never advances j on a
    failed match, attention.py:185-209); COCO captions are effectively
    ASCII, so neither is exercised in the published runs.

    Returns (len(pieces),) int32 with the word index each piece's
    embedding is summed into, or -1 for pieces the walk never consumes.
    """
    seg = np.full(len(pieces), -1, np.int32)
    j = 0
    for wi, word in enumerate(words):
        target = word.replace("#", "").lower()
        built = ""
        while j < len(pieces):
            piece = pieces[j]
            seg[j] = wi
            j += 1
            built += piece.replace("#", "")
            if built.lower() == target or piece == "[UNK]":
                break
    return seg


def caption_keys(captions, lengths=None):
    """The cache key of each caption row: its ids, cut to its true length
    when ``lengths`` are given."""
    if lengths is None:
        return [tuple(int(t) for t in row) for row in captions]
    return [tuple(int(t) for t in row[: max(int(n), 1)])
            for row, n in zip(captions, np.asarray(lengths))]


class BertCaptionEmbedder:
    """Callable: (B, T) vocab-id captions -> (B, T+1, D) aligned
    embeddings (row 0 is [CLS], row t is word t-1; see the module
    docstring), a tensor on ``device``.

    ``model`` is a ``BertEncoder`` and ``tokenizer`` a
    ``bert_tokenize.BertTokenizer``; without them they are read from
    ``BERT_MODEL_DIR`` (``_load_default_bert``). The model moves to
    ``device``, W8A8 with ``int8``.
    """

    def __init__(self, vocab, model=None, tokenizer=None, cache_size=50000,
                 device=None, int8=False):
        self.vocab = vocab
        self._cache = {}
        self._cache_size = cache_size
        # Per-WORD wordpiece memo (see _word_pieces). Unbounded on
        # purpose: its keyspace is the caption vocabulary, not the
        # caption space, so it saturates within the first few hundred
        # batches.
        self._word_memo = {}
        self.counts = dict.fromkeys(
            ("captions", "cache_hits", "pieces_padded", "pieces_own"), 0)
        if model is None or tokenizer is None:
            model, tokenizer = _load_default_bert()
        self.tokenizer = tokenizer
        self.bert = TorchBert(model, resolve_device(device), int8=int8)

    def __call__(self, captions, lengths=None):
        """captions: (B, T) int array -> (B, T+1, D) float32 tensor on
        the device (bert_embed.py:150).

        ``lengths`` (optional, (B,) true caption lengths) is the EVAL
        parity switch: BERT is bidirectional, so the literal '<pad>'
        words of a padded row perturb every other position's contextual
        embedding. The reference TRAINS on padded rows
        (attention.py:242-247) but EVALS at batch 1 where no padding
        exists (attention.py:473-494), so training calls leave
        ``lengths`` unset, while the batched eval passes true lengths so
        each sample's text is its unpadded caption. Rows are zero-padded
        back to the uniform (T+1) window; the eval step never reads past
        a sample's decode length.
        """
        captions = np.asarray(captions)
        return self.bert.aligned(*self.piece_arrays(
            captions, caption_keys(captions, lengths)))

    def _merge_cache(self, keys, fresh):
        """Insert ``fresh`` with eviction that can never drop entries the
        CURRENT call still needs (bert_embed.py:201): on overflow the
        cache resets to exactly this batch's working set (cached and
        needed, plus fresh)."""
        if len(self._cache) + len(fresh) > self._cache_size:
            needed = {k: self._cache[k] for k in keys if k in self._cache}
            self._cache.clear()
            self._cache.update(needed)
        self._cache.update(fresh)

    def _word_pieces(self, word):
        """Per-WORD wordpiece memo: word -> (piece ids, clean)
        (bert_embed.py:216).

        The basic tokenizer splits on whitespace before wordpiece runs
        per basic token, and '[CLS]' is never split, so tokenizing a
        whitespace word in isolation yields exactly its slice of the
        full-caption tokenization. ``clean`` records whether the
        alignment walk (``piece_word_segments``), run on just this
        word's pieces, would break exactly at the last piece: when every
        word of a caption is clean, the caption's walk is the per-word
        concatenation. Any non-clean word routes the whole caption to
        the exact slow walk, so the degradation semantics documented on
        ``piece_word_segments`` are kept bit for bit."""
        hit = self._word_memo.get(word)
        if hit is None:
            pieces = self.tokenizer.tokenize(word)
            ids = np.asarray(self.tokenizer.convert_tokens_to_ids(pieces),
                             np.int32)
            target = word.replace("#", "").lower()
            built, clean = "", False
            for n, piece in enumerate(pieces):
                built += piece.replace("#", "")
                if built.lower() == target or piece == "[UNK]":
                    clean = n == len(pieces) - 1
                    break
            hit = self._word_memo[word] = (ids, clean)
        return hit

    def _tokenize_rows(self, keys):
        """Memoized host string work: caption key -> (piece ids, seg)
        (bert_embed.py:250)."""
        missing = [k for k in dict.fromkeys(keys) if k not in self._cache]
        self.counts["cache_hits"] += len(keys) - len(missing)
        if missing:
            fresh = {}
            for k in missing:
                words = ["[CLS]"] + [self.vocab.i2w[t] for t in k]
                per_word = [self._word_pieces(w) for w in words]
                if all(clean for _, clean in per_word):
                    ids = np.concatenate([w_ids for w_ids, _ in per_word])
                    seg = np.repeat(
                        np.arange(len(words), dtype=np.int32),
                        [len(w_ids) for w_ids, _ in per_word])
                else:
                    text = " ".join(words)
                    pieces = self.tokenizer.tokenize(text)
                    ids = np.asarray(
                        self.tokenizer.convert_tokens_to_ids(pieces),
                        np.int32)
                    # text.split(), not ``words``: an (anomalous) empty
                    # vocab word vanishes in the joined text, and the
                    # walk must see the same word list it always did.
                    seg = piece_word_segments(text.split(), pieces)
                fresh[k] = (ids, seg)
            self._merge_cache(keys, fresh)
        return [self._cache[k] for k in keys]

    def piece_arrays(self, captions, keys):
        """The device path's inputs for ``captions`` (B, T) and their cache
        ``keys``: (B, L) piece ids, attention mask and word segments
        (int32 numpy, L the longest row's pieces) and the word count
        T + 1."""
        with annotate("bert_tokenize"):
            rows = self._tokenize_rows(keys)
            max_len = max(len(ids) for ids, _ in rows)
            ids = np.zeros((len(rows), max_len), np.int32)
            attn = np.zeros((len(rows), max_len), np.int32)
            seg = np.full((len(rows), max_len), -1, np.int32)
            for i, (row_ids, row_seg) in enumerate(rows):
                ids[i, : len(row_ids)] = row_ids
                attn[i, : len(row_ids)] = 1
                seg[i, : len(row_ids)] = row_seg
        self.counts["captions"] += len(rows)
        self.counts["pieces_padded"] += ids.size
        self.counts["pieces_own"] += int(attn.sum())
        return ids, attn, seg, captions.shape[1] + 1  # + [CLS] row


def _load_default_bert():
    """The BERT of the ``save_pretrained`` directory ``BERT_MODEL_DIR``
    (bert_embed.py:291): (``BertEncoder``, ``BertTokenizer``). There is no
    download: without the variable this raises."""
    from .bert_load import bert_from_state_dict, load_bert_dir
    from .bert_tokenize import BertTokenizer

    source = os.environ.get("BERT_MODEL_DIR")
    if not source:
        raise RuntimeError(
            "BERT weights are read from a local save_pretrained directory: "
            "set BERT_MODEL_DIR to one (config.json, model.safetensors or "
            "pytorch_model.bin, vocab.txt), or pass model and tokenizer to "
            "BertCaptionEmbedder")
    state, config = load_bert_dir(source)
    return (bert_from_state_dict(state, config),
            BertTokenizer(os.path.join(source, "vocab.txt")))
