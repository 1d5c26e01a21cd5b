"""The port's caption embedder (icd_tpu_torch/models/bert_embed.py) against
icd_tpu's (models/bert_embed.py), f32 on the CPU: the same tiny BERT
(transformers' ``BertModel`` for icd_tpu, its weights through
``bert_load.bert_from_state_dict`` for the port) and the same
``vocab.txt`` (transformers' tokenizer for icd_tpu, the port's own).

The port has one path (host string work, the forward and the piece ->
word sum on the device); it is held against both of icd_tpu's, the host
path (a torch forward and a numpy alignment) and the device path.

Tolerances, and why: aligned embeddings within atol 3e-5 of either
path, as tests/test_bert_jax.py holds icd_tpu's device path against its
host path (forwards that sum in other orders, then sums of up to three
piece rows); piece ids, word segments and cache keys equal (string
work).

Sizes: 21 wordpieces, hidden 16, 2 layers, 2 heads, FFN 32.
"""

import numpy as np
import pytest
import torch

from icd_tpu.models import bert_embed as jax_be
from icd_tpu_torch.models.bert_embed import (BertCaptionEmbedder,
                                             piece_word_segments)
from icd_tpu_torch.models.bert_load import bert_from_state_dict
from icd_tpu_torch.models.bert_tokenize import BertTokenizer
from icd_tpu_torch.vocabulary import (END_TOKEN, PAD_TOKEN, START_TOKEN,
                                      UNK_TOKEN, Vocabulary)

WORDPIECES = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "man", "rid", "##ing",
    "horse", "on", "the", "beach", ".", "<", "start", "end", "pad", "unk",
    ">", "cafe", "dog", "'", "s",
]
WORDS = ["a", "man", "riding", "horse", "on", "the", "beach", ".", "café",
         "zzz", "dog's", ""]


@pytest.fixture(scope="module")
def berts(tmp_path_factory):
    """(icd_tpu's model and tokenizer, the port's)."""
    from transformers import BertConfig, BertModel
    from transformers import BertTokenizer as HFBertTokenizer

    path = tmp_path_factory.mktemp("bertvocab") / "vocab.txt"
    path.write_text("\n".join(WORDPIECES))
    torch.manual_seed(0)
    config = BertConfig(vocab_size=len(WORDPIECES), hidden_size=16,
                        num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=32, max_position_embeddings=64)
    model = BertModel(config).eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    port = bert_from_state_dict(state, config.to_dict())
    return ((model, HFBertTokenizer(str(path), do_lower_case=True)),
            (port, BertTokenizer(str(path))))


@pytest.fixture(scope="module")
def vocab():
    v = Vocabulary()
    v.add_word(PAD_TOKEN)
    for w in WORDS:
        v.add_word(w)
    v.add_word(START_TOKEN)
    v.add_word(END_TOKEN)
    v.add_word(UNK_TOKEN)
    return v


def _captions(v, rows):
    """Rows of words -> (B, T) ids, each <start> ... <end>, padded."""
    t = max(len(r) for r in rows) + 2
    out = np.zeros((len(rows), t), np.int32)
    for i, row in enumerate(rows):
        ids = [v(START_TOKEN)] + [v(w) for w in row] + [v(END_TOKEN)]
        out[i, :len(ids)] = ids
    return out


ROWS = [["a", "man", "riding", "a", "horse"], ["the", "beach", "."],
        ["dog's", "zzz", "on", "the", "beach"], ["café", "riding"],
        ["a", "man", "riding", "a", "horse"]]


def _embedders(berts, vocab, jax_host, **kw):
    """(icd_tpu's embedder on its host path, or on its device path, the
    port's on the CPU)."""
    (model, tokenizer), (port, port_tokenizer) = berts
    want = jax_be.BertCaptionEmbedder(vocab, model=model, tokenizer=tokenizer,
                                      device=not jax_host, **kw)
    got = BertCaptionEmbedder(vocab, model=port, tokenizer=port_tokenizer,
                              device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("jax_host", [True, False])
def test_embedder_matches_icd_tpu(berts, vocab, jax_host, with_lengths):
    """Against both of icd_tpu's paths, padded rows (training) and true
    lengths (eval), a word of two pieces, an [UNK], a word that breaks
    the per-word memo (café normalizes to cafe) and a repeated
    caption."""
    want_e, got_e = _embedders(berts, vocab, jax_host)
    caps = _captions(vocab, ROWS)
    kw = {}
    if with_lengths:
        kw["lengths"] = (caps != 0).sum(1)
    want = np.asarray(want_e(caps, **kw))
    got = got_e(caps, **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (5, caps.shape[1] + 1, 16)
    np.testing.assert_allclose(got, want, atol=3e-5)
    if with_lengths:  # rows past each caption stay zero
        for row, n in zip(got, kw["lengths"]):
            assert not row[n + 1:].any()


@pytest.mark.parametrize("jax_host", [True, False])
def test_cache_and_eviction_match_icd_tpu(berts, vocab, jax_host):
    """A cache of 3 captions: the same keys as icd_tpu's (either path)
    after every call, eviction never drops what the current call needs,
    and a cached caption gives the same rows as a fresh one."""
    want_e, got_e = _embedders(berts, vocab, jax_host, cache_size=3)
    calls = [ROWS[:2], ROWS[1:3], ROWS[2:5], [ROWS[0]], ROWS[:4]]
    first = None
    for rows in calls:
        caps = _captions(vocab, rows)
        want = np.asarray(want_e(caps))
        got = np.asarray(got_e(caps))
        np.testing.assert_allclose(got, want, atol=3e-5)
        assert set(got_e._cache) == set(want_e._cache)
        if first is None:
            first = got
    fresh = BertCaptionEmbedder(vocab, model=berts[1][0],
                                tokenizer=berts[1][1], device="cpu")
    np.testing.assert_array_equal(
        np.asarray(fresh(_captions(vocab, ROWS[:2]))), first)


def test_word_memo_matches_full_tokenize(berts, vocab):
    """Each word's memoized pieces are its slice of the full caption's
    tokenization; a caption whose words are all clean takes the memo's
    ids and segments, the others the full walk; both equal icd_tpu's."""
    want_e, got_e = _embedders(berts, vocab, False)
    tokenizer = berts[1][1]
    for word in ["[CLS]"] + WORDS + [START_TOKEN, PAD_TOKEN]:
        ids, clean = got_e._word_pieces(word)
        w_ids, w_clean = want_e._word_pieces(word)
        assert clean == w_clean
        np.testing.assert_array_equal(ids, w_ids)
        np.testing.assert_array_equal(ids, tokenizer.convert_tokens_to_ids(
            tokenizer.tokenize(word)))
    keys = [tuple(int(t) for t in row) for row in _captions(vocab, ROWS)]
    for (ids, seg), (w_ids, w_seg), key in zip(
            got_e._tokenize_rows(keys), want_e._tokenize_rows(keys), keys):
        np.testing.assert_array_equal(ids, w_ids)
        np.testing.assert_array_equal(seg, w_seg)
        text = "[CLS] " + " ".join(vocab.i2w[t] for t in key)
        pieces = tokenizer.tokenize(text)
        np.testing.assert_array_equal(
            ids, tokenizer.convert_tokens_to_ids(pieces))
        np.testing.assert_array_equal(
            seg, piece_word_segments(text.split(), pieces))


SEGMENT_CASES = [
    (["[CLS]", "a", "rid", "##ing", "horse"], ["[CLS]", "a", "riding", "horse"]),
    (["[CLS]", "[UNK]", "beach"], ["[CLS]", "zzz", "beach"]),
    (["[CLS]", "a"], ["[CLS]", "a", "man", "horse"]),
    (["[CLS]", "a", "man", "runs"], ["[CLS]", "a"]),
    (["[CLS]", "cafe", "a"], ["[CLS]", "café", "a"]),
    (["[CLS]", "dog", "'", "s"], ["[CLS]", "dog's"]),
]


@pytest.mark.parametrize("pieces,words", SEGMENT_CASES)
def test_piece_word_segments_match_align(pieces, words):
    """The index-only walk equals icd_tpu's, and its sums are the rows of
    icd_tpu's host alignment (``align_pieces_to_words``)."""
    rng = np.random.default_rng(7)
    embs = rng.normal(size=(len(pieces), 4)).astype(np.float32)
    expected = jax_be.align_pieces_to_words(words, pieces, embs)
    seg = piece_word_segments(words, pieces)
    np.testing.assert_array_equal(seg,
                                  jax_be.piece_word_segments(words, pieces))
    got = np.zeros((len(words), 4), np.float32)
    for j, w in enumerate(seg):
        if w >= 0:
            got[w] += embs[j]
    np.testing.assert_allclose(got, expected, atol=1e-6)


def test_default_bert_needs_bert_model_dir(vocab, monkeypatch):
    monkeypatch.delenv("BERT_MODEL_DIR", raising=False)
    with pytest.raises(RuntimeError, match="BERT_MODEL_DIR"):
        BertCaptionEmbedder(vocab, device="cpu")
