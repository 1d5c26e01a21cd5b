"""The --use_bert captioner as the benchmark's ``sat-bert-resnet101``
configuration trains it, against the plain reference of
``portbench/reference`` (``bert.py``, ``train_bert.py``), on seeded
random weights at a tiny size on the CPU (``tiny-sat-bert``: BERT of 2
layers, hidden 64, 4 heads, FFN 128 over 200 WordPiece entries; the
decoder at E = 64):

- the program's pieces and piece -> word segments
  (``BertCaptionEmbedder.piece_arrays``) equal the reference
  tokenizer's and walk's exactly, padding and the ``<start>``, ``<end>``
  and ``<pad>`` words included;
- the aligned embeddings (padded batch, masked keys) agree with the
  reference's (one caption at a time, no mask) at float32 rounding;
- two train steps through ``stage_batches`` / ``with_bert`` /
  ``make_train_step`` agree with the reference's in loss, gradients and
  the parameters' change;
- ``bert_tokenize`` and ``bert_forward`` are spans under a profiler,
  on the producer thread of ``stage_batches`` too, and nothing without
  one; ``with_bert`` leaves the loader's batch as it was;
- a batch padded to its length bucket, as a captured CUDA graph runs
  it, gives the unpadded batch's embeddings; ``capture`` makes no graph
  on the CPU. On a card (skipped without one): the graphs' replays give
  the eager forward's embeddings, batch after batch.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from icd_tpu_torch.models.attention import AttentionDecoder
from icd_tpu_torch.models.bert import (BertEncoder, aligned_sum,
                                       bert_encoder_forward, length_bucket,
                                       pad_pieces)
from icd_tpu_torch.models.bert_embed import BertCaptionEmbedder, caption_keys
from icd_tpu_torch.models.bert_tokenize import BertTokenizer
from icd_tpu_torch.models.encoder import EncoderAttention
from icd_tpu_torch.models.resnet import ResNet
from icd_tpu_torch.training import attention as ta
from icd_tpu_torch.training import common
from icd_tpu_torch.utils import profiling
from icd_tpu_torch.vocabulary import Vocabulary
from portbench import bert_inputs, traffic
from portbench import weights as W
from portbench.reference import bert as ref_bert
from portbench.reference import train_bert as ref_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "portbench", "tests", "data")
SEED = 2 ** 33 + 5


def _json(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg, tr = _json("tiny-sat-bert.json"), _json("tiny_train_bert.json")
    words = bert_inputs.caption_words(cfg, SEED)
    path = bert_inputs.write_wordpiece_vocab(
        str(tmp_path_factory.mktemp("bert") / "vocab.txt"), cfg, words, SEED)
    bert_w = bert_inputs.make_bert(cfg["bert"], SEED, torch.device("cpu"))
    pool = traffic.train_batches(tr, cfg, SEED)
    return types.SimpleNamespace(cfg=cfg, tr=tr, words=words, path=path,
                                 bert_w=bert_w, pool=pool)


def _embedder(world, device="cpu"):
    vocab = Vocabulary()
    for word in world.words:
        vocab.add_word(word)
    bert = BertEncoder.from_config(world.cfg["bert"], "cpu")
    bert.load_state_dict(W.subtree(world.bert_w, "bert."))
    return BertCaptionEmbedder(vocab, model=bert,
                               tokenizer=BertTokenizer(world.path),
                               device=device)


def _reference(world):
    return ref_bert.Embedder(world.bert_w, world.cfg["bert"], world.path,
                             world.words)


def _batch(world, k):
    return bert_inputs.fresh_captions(world.pool[k % len(world.pool)],
                                      world.cfg["vocab_size"], SEED, k)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_pieces_and_segments_equal_the_reference(world, k):
    captions = _batch(world, k)["captions"]
    ids, mask, seg, n_words = _embedder(world).piece_arrays(
        captions, caption_keys(captions))
    assert n_words == captions.shape[1] + 1
    want = _reference(world).pieces(captions)
    assert ids.shape[1] == max(len(i) for i, _ in want)
    for r, (row_ids, row_seg) in enumerate(want):
        n = len(row_ids)
        assert ids[r, :n].tolist() == row_ids
        assert seg[r, :n].tolist() == row_seg
        assert mask[r, :n].all() and not mask[r, n:].any()
        assert not ids[r, n:].any() and (seg[r, n:] == -1).all()
    # Every word takes a piece, and each <pad> word three.
    assert (seg.max(axis=1) == captions.shape[1]).all()


@pytest.mark.parametrize("k", [0, 1, 2])
def test_aligned_embeddings_agree_with_the_reference(world, k):
    captions = _batch(world, k)["captions"]
    got = _embedder(world)(captions)
    want = _reference(world)(captions)
    assert got.shape == want.shape == (len(captions), captions.shape[1] + 1,
                                       world.cfg["bert"]["hidden_size"])
    gap = (got - want).norm(dim=-1) / want.norm(dim=-1)
    # float32 rounding alone: the padded batch's products sum in another
    # order than one caption's, and its masked keys add exact zeros to
    # the softmax; two layers of it read under 4e-7 a word row here.
    assert float(gap.max()) < 1e-5


def _word_gap(got, want):
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


@pytest.mark.parametrize("k", [0, 1, 2])
def test_a_batch_padded_to_its_bucket_embeds_as_unpadded(world, k):
    embedder = _embedder(world)
    captions = _batch(world, k)["captions"]
    ids, mask, seg, n_words = embedder.piece_arrays(
        captions, caption_keys(captions))
    length = length_bucket(ids.shape[1])
    assert length % 16 == 0 and 0 <= length - ids.shape[1] < 16
    padded = [torch.from_numpy(a.astype(np.int64))
              for a in pad_pieces(ids, mask, seg, length)]
    assert padded[0].shape == (len(captions), length)
    assert not padded[1][:, ids.shape[1]:].any()
    assert (padded[2][:, ids.shape[1]:] == -1).all()
    bert = embedder.bert.bert
    got = aligned_sum(bert_encoder_forward(bert, *padded[:2]), padded[2],
                      n_words)
    # The padded keys' probabilities are exact zeros; the products over
    # more keys may sum in another order: float32 rounding, as above.
    assert _word_gap(got, embedder(captions)) < 1e-6
    assert embedder.bert.capture(len(captions)) == 0


def test_captured_graphs_replay_the_eager_forward(world):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    eager, graphs = _embedder(world, "cuda"), _embedder(world, "cuda")
    rows = world.tr["batch"]
    top = world.cfg["bert"]["max_position_embeddings"]
    assert graphs.bert.capture(rows, 40) == 3  # buckets 16, 32 and 48
    assert graphs.bert.capture(rows) == top // 16
    for k in range(4):
        captions = _batch(world, k)["captions"]
        want = eager(captions)
        got = graphs(captions)
        assert _word_gap(got, want) < 1e-6
        # The next replay overwrites the graph's buffers, not the words
        # it handed out.
        if k:
            assert _word_gap(prev_got, prev_want) < 1e-6
        prev_got, prev_want = got, want
    # Another batch size has no graph and runs eagerly.
    captions = _batch(world, 0)["captions"][:3]
    assert _word_gap(graphs(captions), eager(captions)) < 1e-6


def _program_steps(world, batches, dropout_seed):
    cfg = world.cfg
    w = W.make(cfg, 11, torch.device("cpu"))
    with torch.device("meta"):
        resnet = ResNet(cfg["resnet_depths"], cfg["resnet_widths"])
        decoder = AttentionDecoder(cfg["vocab_size"], cfg["attention_dim"],
                                   cfg["decoder_dim"], cfg["embed_size"],
                                   W.encoder_dim(cfg))
    encoder = EncoderAttention(W.load(resnet, w, "resnet."))
    decoder = W.load(decoder, w, "decoder.")
    args = types.SimpleNamespace(fine_tune_embedding=True, use_bert=True,
                                 encoder_lr=cfg["encoder_lr"],
                                 decoder_lr=cfg["decoder_lr"])
    optimizer = common.make_adam(args, encoder, decoder, None)
    step = ta.make_train_step(encoder, decoder, optimizer, cfg["alpha_c"],
                              cfg["dropout"], cfg["grad_clip"])
    run = ta.batch_step(step, "cpu",
                        torch.Generator().manual_seed(dropout_seed))
    prepare = ta.with_bert(_embedder(world))
    losses, first = [], None
    for batch in batches:
        losses += common.train_epoch(
            run, common.stage_batches([batch], "cpu", prepare=prepare),
            num_batches=0, verbose=False)
        if first is None:
            first = {"decoder." + k: optimizer.state[p]["exp_avg"] / 0.1
                     for k, p in decoder.named_parameters()
                     if p.requires_grad}
    params = {"decoder." + k: p.detach()
              for k, p in decoder.named_parameters() if p.requires_grad}
    return w, losses, first, params


def test_two_steps_agree_with_the_reference(world):
    cfg = world.cfg
    batches = [_batch(world, k) for k in range(2)]
    w, losses, first, params = _program_steps(world, batches, 13)
    assert "decoder.embedding.weight" not in params  # frozen under BERT

    reference = _reference(world)
    trainer = ref_train.Trainer(w, cfg)
    generator = torch.Generator().manual_seed(13)
    ref_losses, ref_first = [], None
    for batch in batches:
        caps = torch.as_tensor(batch["captions"])
        b, t = caps.shape
        keep = torch.rand((b, t - 1, cfg["decoder_dim"]),
                          generator=generator) < 1.0 - cfg["dropout"]
        loss, grads = trainer.step(torch.as_tensor(batch["imgs"]), caps,
                                   keep, reference(batch["captions"]))
        ref_losses.append(float(loss))
        ref_first = grads if ref_first is None else ref_first
    assert sorted(ref_first) == sorted(first)
    # float32: the two sum the same terms in other orders (1e-7 here).
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    norms = torch.stack([g.norm() for g in ref_first.values()])
    floor = float(norms.median())
    for k, g in ref_first.items():
        # Each leaf's first gradient, against the larger of its norm and
        # the median leaf's: rounding of the same sums (2e-6 here).
        assert float((first[k] - g).norm()) <= 1e-4 * max(float(g.norm()),
                                                          floor), k
    # The parameters' change, over the leaves with a gradient (the
    # attention score's bias has none under the softmax, and moves by
    # round-off alone, a whole Adam step either way).
    moved = [k for k, g in ref_first.items()
             if float(g.norm()) >= 1e-3 * floor]
    assert "decoder.attention.full_att.bias" not in moved
    changes = {k: trainer.params[k] - w[k] for k in moved}
    floor = float(torch.stack([c.norm() for c in changes.values()]).median())
    for k, change in changes.items():
        # Adam's first steps divide each gradient by its own magnitude,
        # so a rounding-sized gradient element moves a whole step either
        # way; the leaves' changes agree to 1e-3 of the median leaf's.
        gap = float((params[k] - w[k] - change).norm())
        assert gap <= 1e-3 * max(float(change.norm()), floor), k


def _spans(fn, all_threads=False):
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], **kw) as prof:
        fn()
    return sorted((e.name, e.time_range.start, e.time_range.end, e.thread)
                  for e in prof.events()
                  if e.name in ("bert_tokenize", "bert_forward",
                                "train_step"))


def test_bert_spans_under_a_profiler_and_none_without(world, monkeypatch):
    embedder = _embedder(world)
    captions = _batch(world, 0)["captions"]
    spans = _spans(lambda: embedder(captions))
    assert [s[0] for s in spans] == ["bert_forward", "bert_tokenize"]
    forward, tokenize = spans
    assert tokenize[2] <= forward[1]  # the string work, then the forward

    def refuse(name):
        raise AssertionError("a span without a profiler: " + name)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("bert_forward") is profiling.annotate("x")
    embedder(captions)


def test_bert_spans_on_the_producer_thread(world):
    embedder = _embedder(world)
    prepare = ta.with_bert(embedder)
    batches = [_batch(world, k) for k in range(2)]

    def epoch():
        common.train_epoch(lambda batch: batch["embeddings"].sum(),
                           common.stage_batches(batches, "cpu",
                                                prepare=prepare),
                           num_batches=0, verbose=False)

    spans = _spans(epoch, all_threads=True)
    named = {n: [s for s in spans if s[0] == n]
             for n in ("bert_tokenize", "bert_forward", "train_step")}
    assert all(len(v) == 2 for v in named.values()), spans
    producer = {s[3] for s in named["bert_forward"] + named["bert_tokenize"]}
    assert len(producer) == 1
    assert producer != {s[3] for s in named["train_step"]}


def test_with_bert_leaves_the_loaders_batch_and_counts(world):
    embedder = _embedder(world)
    batch = _batch(world, 0)
    keys = set(batch)
    out = ta.with_bert(embedder)(batch)
    assert set(batch) == keys and "embeddings" in out
    assert out["captions"] is batch["captions"]
    again = ta.with_bert(embedder)(batch)
    torch.testing.assert_close(again["embeddings"], out["embeddings"],
                               rtol=0, atol=0)
    b, t = batch["captions"].shape
    counts = embedder.counts
    assert counts["captions"] == 2 * b and counts["cache_hits"] == b
    pieces = [len(i) for i, _ in _reference(world).pieces(batch["captions"])]
    assert counts["pieces_own"] == 2 * sum(pieces)
    assert counts["pieces_padded"] == 2 * b * max(pieces)
