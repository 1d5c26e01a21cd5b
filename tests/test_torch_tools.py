"""The port's notebook tools against the repository's: ``python -m
icd_tpu_torch.captions_demo`` / ``training_plots`` / ``validation_plots``
against ``tools/captions_demo.py`` / ``training_plots.py`` /
``validation_plots.py``, f32 on the CPU.

- ``caption_teacher_forced`` of both on the same seeded trees (converted
  by ``params.py``) and the same images and captions, for the attention
  model, the baseline model and the attention model over a tiny BERT
  (hidden 16, 2 layers: transformers' model for the tool, its weights
  through ``bert_load`` for the port): equal words. The argmax of f32
  scores that the two packages sum in other orders; a tie within their
  ~1e-6 difference would flip a word, and none of these inputs has one.
- One run of each CLI with ``--device cpu`` on a copy of
  ``tests/conftest.py``'s ``coco_root`` (4 val captions), beside one run
  of each tool on the same checkpoints (written by the port, read by
  both) and ``eval_data``: equal lines (but COCO's "Done (t=...)" load
  time), and the same plot file.

Sizes: a (1, 1, 1, 1) ResNet of widths (4, 4, 8, 8), A = 10, H = 12,
E = 16, 64 x 64 images in the function tests, the dataset's 224 x 224 in
the CLI ones.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from icd_tpu.models import bert_embed as jax_be
from icd_tpu_torch import captions_demo, training_plots, validation_plots
from icd_tpu_torch.checkpoint import save_checkpoint
from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                            init_attention_decoder)
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.bert_embed import BertCaptionEmbedder
from icd_tpu_torch.models.bert_load import bert_from_state_dict
from icd_tpu_torch.models.bert_tokenize import BertTokenizer
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.params import (decoder_from_jax, decoder_to_jax,
                                  encoder_from_jax, resnet_to_jax)
from icd_tpu_torch.train import build_parser
from icd_tpu_torch.vocabulary import (END_TOKEN, PAD_TOKEN, START_TOKEN,
                                      UNK_TOKEN, Vocabulary, load_vocab)
from helpers import SMALL_DEPTHS, SMALL_DIM, SMALL_WIDTHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import captions_demo as tool_demo  # noqa: E402

WORDS = ["a", "man", "riding", "horse", "on", "the", "beach", "."]
WORDPIECES = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "man",
              "rid", "##ing", "horse", "on", "the", "beach", ".", "<",
              "start", "end", "pad", "unk", ">"]


def _trees(vocab_size, embed_size=16, seed=0):
    """Seeded (encoder, decoder) trees of both families, small."""
    g = torch.Generator().manual_seed(seed)
    resnet = resnet_to_jax(init_resnet(g, SMALL_DEPTHS, SMALL_WIDTHS,
                                       device="cpu"))
    att = AttentionDecoderParams()
    att.attention_dim, att.decoder_dim, att.embed_size = 10, 12, embed_size
    att.vocab = range(vocab_size)
    dec = init_attention_decoder(g, att, encoder_dim=SMALL_DIM, device="cpu")
    base = BaselineDecoderParams()
    base.vocab_size, base.embed_size, base.hidden_size = vocab_size, 16, 12
    head = {"w": torch.randn(SMALL_DIM, 16, generator=g).numpy() * 0.1,
            "b": torch.randn(16, generator=g).numpy() * 0.1}
    return {
        "attention": ({"resnet": resnet}, decoder_to_jax(dec)),
        "baseline": ({"resnet": resnet, "embed": head}, decoder_to_jax(
            init_baseline_decoder(g, base, device="cpu"))),
    }


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A vocabulary, images and captions, and a tiny BERT for each
    package."""
    from transformers import BertConfig, BertModel
    from transformers import BertTokenizer as HFBertTokenizer

    vocab = Vocabulary()
    for w in [PAD_TOKEN] + WORDS + [START_TOKEN, END_TOKEN, UNK_TOKEN]:
        vocab.add_word(w)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    captions = [np.asarray([vocab(START_TOKEN)]
                           + [vocab(w) for w in rng.choice(WORDS, n)]
                           + [vocab(END_TOKEN)], np.int32)
                for n in (4, 7, 5)]
    path = str(tmp_path_factory.mktemp("bertvocab") / "vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(WORDPIECES))
    torch.manual_seed(0)
    config = BertConfig(vocab_size=len(WORDPIECES), hidden_size=16,
                        num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=32, max_position_embeddings=64)
    model = BertModel(config).eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    berts = (jax_be.BertCaptionEmbedder(
                 vocab, model=model,
                 tokenizer=HFBertTokenizer(path, do_lower_case=True)),
             BertCaptionEmbedder(vocab, model=bert_from_state_dict(
                 state, config.to_dict()), tokenizer=BertTokenizer(path),
                 device="cpu"))
    return vocab, imgs, captions, berts


@pytest.mark.parametrize("family", ["attention", "baseline", "bert"])
def test_caption_teacher_forced_equals_the_tools(tiny, family):
    vocab, imgs, captions, (jax_bert, port_bert) = tiny
    model_type = "baseline" if family == "baseline" else "attention"
    enc, dec = _trees(len(vocab), seed=1)[model_type]
    encoder, decoder = encoder_from_jax(enc), decoder_from_jax(dec)
    bert = family == "bert"
    got, want = [], []
    for img, caption in zip(imgs, captions):
        got.append(captions_demo.caption_teacher_forced(
            model_type, encoder, decoder, img, caption, vocab,
            bert_embedder=port_bert if bert else None))
        want.append(tool_demo.caption_teacher_forced(
            model_type, enc, dec, img, caption, vocab,
            bert_embedder=jax_bert if bert else None))
    assert got == want
    assert all(got)  # every caption has words
    scores = captions_demo.decoder_scores(
        model_type, decoder, captions_demo.image_features(
            model_type, encoder, imgs[0]), captions[0],
        port_bert if bert else None)
    steps = len(captions[0]) - (model_type != "baseline")
    assert scores.shape == (1, steps, len(vocab))
    assert scores.dtype == torch.float32


def _filtered(lines):
    return [line for line in lines if not line.startswith("Done (t=")]


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def tool_runs(coco_root, tmp_path_factory):
    """Both packages' CLIs on one root: the tools in subprocesses (all
    three at once), the port's in this process."""
    root = tmp_path_factory.mktemp("tools_root")
    for part in ("cocoapi", "pkldata"):
        shutil.copytree(os.path.join(coco_root, part), root / part)
    for part in ("checkpoints", "eval_data", "port_cwd"):
        (root / part).mkdir()
    root = str(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("ICD_TPU_ROOT", root)
    try:
        trees = _trees(len(load_vocab()), seed=2)
        ckpts = []
        for name, fam, epoch, losses in (
                ("tinyatt", "attention", 0, [[4.0, 3.5]]),
                ("tinyatt", "attention", 1, [[4.0, 3.5], [3.0, 2.75]]),
                ("tinybase", "baseline", 0, [[5.0, 4.0, 2.5]])):
            args = build_parser().parse_args(
                [name, "--model", fam, "--embed_size", "16",
                 "--decoder_dim", "12", "--attention_dim", "10"])
            ckpts.append(save_checkpoint(args, epoch, *trees[fam], None,
                                         None, {"epoch_losses": losses}))
        for i, stem in enumerate(("tinyatt_1", "tinybase_0")):
            with open(os.path.join(root, "eval_data", stem + ".json"),
                      "w") as f:
                json.dump({"Bleu_1": 0.51234 + i, "Bleu_2": 0.4,
                           "Bleu_3": 0.3, "Bleu_4": 0.2, "METEOR": 0.1,
                           "ROUGE_L": 0.45, "CIDEr": 1.2 - i,
                           "losses": [2.0, 2.25 + i]}, f)
        demo = ["tinyatt_1.ckpt:attention", "tinybase_0.ckpt",
                "--num_images", "3", "--seed", "5"]
        env = dict(os.environ, ICD_TPU_ROOT=root, JAX_PLATFORMS="cpu")
        tools = {
            "captions_demo": demo,
            "training_plots": ckpts,
            "validation_plots": []}
        procs = {name: subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", name + ".py"),
             *argv], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for name, argv in tools.items()}
        try:
            port = {"captions_demo": _run(captions_demo.main,
                                          demo + ["--device", "cpu"]),
                    "validation_plots": _run(validation_plots.main, [])}
            with mp.context() as m:
                m.chdir(os.path.join(root, "port_cwd"))
                port["training_plots"] = _run(training_plots.main, ckpts)
            tool = {}
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=300)
                assert proc.returncode == 0, (name, err[-3000:])
                tool[name] = out.splitlines()
        finally:
            for proc in procs.values():
                proc.kill()
        yield dict(root=root, port=port, tool=tool)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["captions_demo", "training_plots",
                                  "validation_plots"])
def test_cli_lines_equal_the_tools(tool_runs, name):
    got = _filtered(tool_runs["port"][name])
    assert got == _filtered(tool_runs["tool"][name])
    expect = {"captions_demo": "truth:", "training_plots":
              "Saved train_loss.jpg", "validation_plots": "begin{tabular}"}
    assert any(expect[name] in line for line in got)


def test_captions_demo_prints_every_model(tool_runs):
    lines = tool_runs["port"]["captions_demo"]
    assert sum(line.startswith("image:") for line in lines) == 3
    assert sum("tinyatt_1.ckpt:" in line for line in lines) == 3
    assert sum("tinybase_0.ckpt:" in line for line in lines) == 3


def test_training_plots_writes_the_tools_plot(tool_runs):
    root = tool_runs["root"]
    with open(os.path.join(root, "port_cwd", "train_loss.jpg"), "rb") as f:
        got = f.read()
    with open(os.path.join(root, "train_loss.jpg"), "rb") as f:
        want = f.read()
    assert got[:2] == b"\xff\xd8" and got == want


def test_training_plots_and_validation_plots_without_inputs(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("ICD_TPU_ROOT", str(tmp_path))
    assert _run(training_plots.main, []) == [
        "No checkpoints with epoch_losses found."]
    assert _run(validation_plots.main, []) == ["No eval_data/*.json found."]
    assert training_plots.avg_losses([[3.0, 1.0], [2.0]]) == [3.0, 2.0, 2.0]
