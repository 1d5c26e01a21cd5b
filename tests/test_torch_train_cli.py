"""``python -m icd_tpu_torch.{train,eval,init}`` against icd_tpu's
drivers on the ``coco_root`` fixture (8 train captions, 4 val captions),
f32 on the CPU, dropout 0.

One module fixture runs icd_tpu's ``training.attention.train`` for epoch
0 (a (1, 1, 1, 1) ResNet of widths (4, 4, 8, 8), A = 10, H = 12,
E = 16, batch 4), then resumes epoch 1 from that checkpoint twice:
with icd_tpu and with the port's CLI. Then both evaluate the port's
epoch-1 checkpoint. Last, the port's CLI trains epoch 0 from its own
random weights and both packages resume epoch 1 from that checkpoint,
whose Adam state the port writes in optax's layout.

Tolerances, and why: the port and XLA sum in other orders, so the
per-batch losses agree to rtol 1e-5 and their printed lines (4
decimals) are equal; the saved decoders to atol 1e-2 * lr per step
(tests/test_torch_train.py: a gradient element near Adam's eps turns
its rounding into up to 1e-2 of a step), the score bias (zero gradient
in exact arithmetic) to lr a step; Adam's moments to 1e-4 of each
tensor's largest value. Eval: per-sample losses rtol 1e-5; the argmax
hypotheses are equal, so Bleu_1-4, METEOR (the pure-Python backend,
``ICD_TPU_METEOR_PY=1``), ROUGE_L and CIDEr are equal.
"""

import contextlib
import functools
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest

import icd_tpu.models.attention as jax_ma
import icd_tpu.training.attention as jax_ta
import icd_tpu_torch.training.attention as ta
from icd_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from icd_tpu.vocabulary import build_vocab as jax_build_vocab
from icd_tpu.vocabulary import load_vocab as jax_load_vocab
from icd_tpu_torch import eval as port_eval
from icd_tpu_torch import init as port_init
from icd_tpu_torch import train as port_train
from icd_tpu_torch.models.attention import init_attention_decoder
from icd_tpu_torch.models.encoder import EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.params import adam_moments
from helpers import (SMALL_DEPTHS, SMALL_DIM, SMALL_WIDTHS, make_train_args,
                     small_init_encoder_attention)

SIZES = dict(batch_size=4, embed_size=16, decoder_dim=12, attention_dim=10,
             workers=0, decoder_dropout=0.0)
LR = 1e-4  # the CLI's default decoder_lr


def _flags(**kw):
    out = ["--model", "attention", "--device", "cpu"]
    for key, value in dict(SIZES, **kw).items():
        out += ["--" + key, str(value)]
    return out


def _run(fn, *args, **kw):
    """fn's printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def _loss_lines(lines):
    """The per-batch lines without their host-timing column."""
    return [line.split(", Time:")[0] for line in lines
            if line.startswith("Epoch ")]


def _small_port_encoder(generator, dtype=None, device=None):
    return EncoderAttention(init_resnet(generator, SMALL_DEPTHS,
                                        SMALL_WIDTHS, device=device))


@pytest.fixture(scope="module")
def runs(coco_root):
    mp = pytest.MonkeyPatch()
    mp.setenv("ICD_TPU_ROOT", coco_root)
    mp.setenv("ICD_TPU_METEOR_PY", "1")
    mp.setattr(jax_ta, "init_encoder_attention",
               small_init_encoder_attention)
    mp.setattr(jax_ta, "init_attention_decoder", functools.partial(
        jax_ma.init_attention_decoder, encoder_dim=SMALL_DIM))
    try:
        jax_ta.train(make_train_args(model="attention",
                                     model_name="tcli_jx", **SIZES))
        jax_lines = _run(jax_ta.train, make_train_args(
            model="attention", model_name="tcli_jx", epochs=2,
            checkpoint="tcli_jx_0.ckpt", **SIZES))
        port_lines = _run(port_train.main, ["tcli_pt"] + _flags(
            epochs=2, checkpoint="tcli_jx_0.ckpt"))
        args = make_train_args(model_name="tcli_pt", checkpoint="tcli_pt_1.ckpt")
        chkpt = jax_load_checkpoint(name="tcli_pt_1.ckpt")
        jax_metrics = jax_ta.evaluate(args, chkpt["encoder"],
                                      chkpt["decoder"])
        eval_lines = _run(port_eval.main, ["tcli_pt_1.ckpt", "--model_type",
                                           "attention", "--device", "cpu"])
        with open(os.path.join(coco_root, "eval_data",
                               "tcli_pt_1.json")) as f:
            port_metrics = json.load(f)
        mp.setattr(ta, "init_encoder_attention", _small_port_encoder)
        mp.setattr(ta, "init_attention_decoder", functools.partial(
            init_attention_decoder, encoder_dim=SMALL_DIM))
        _run(port_train.main, ["tcli_p0"] + _flags())
        _run(jax_ta.train, make_train_args(
            model="attention", model_name="tcli_pj", epochs=2,
            checkpoint="tcli_p0_0.ckpt", **SIZES))
        _run(port_train.main, ["tcli_pp"] + _flags(
            epochs=2, checkpoint="tcli_p0_0.ckpt"))
        yield dict(root=coco_root, jax_lines=jax_lines,
                   port_lines=port_lines, jax_metrics=jax_metrics,
                   port_metrics=port_metrics, eval_lines=eval_lines)
    finally:
        mp.undo()


def test_resume_from_icd_tpu_checkpoint_matches_icd_tpu(runs):
    want = jax_load_checkpoint(name="tcli_jx_1.ckpt")
    got = jax_load_checkpoint(name="tcli_pt_1.ckpt")
    assert got["epoch"] == want["epoch"] == 1
    w_losses, g_losses = (c["metrics"]["epoch_losses"] for c in (want, got))
    assert len(g_losses) == len(w_losses) == 2
    assert g_losses[0] == w_losses[0]  # epoch 0, carried over
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=1e-5)
    assert _loss_lines(runs["port_lines"]) == _loss_lines(runs["jax_lines"])
    assert "Model tcli_pt finished training for 2 epochs." in runs[
        "port_lines"]

    dec, want_dec = got["decoder"], want["decoder"]
    np.testing.assert_allclose(dec["attention"]["full_att"].pop("b"),
                               want_dec["attention"]["full_att"].pop("b"),
                               atol=2 * LR)
    for g, w in zip(jax.tree_util.tree_leaves(dec),
                    jax.tree_util.tree_leaves(want_dec)):
        np.testing.assert_allclose(g, w, atol=1e-2 * LR * 2)
    # The frozen encoder: equal weights, train-mode BN statistics close.
    for g, w in zip(jax.tree_util.tree_leaves(got["encoder"]),
                    jax.tree_util.tree_leaves(want["encoder"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)

    # Adam: the port's state (read back to its numpy form) against
    # icd_tpu's.
    state = adam_moments(got["decoder_optimizer"])
    adam = want["decoder_optimizer"].inner_states["decoder"].inner_state[1][0]
    assert int(state["count"]) == int(adam.count) == 4
    for mine, theirs in ((state["mu"], adam.mu), (state["nu"], adam.nu)):
        theirs = theirs["decoder"]
        mine = mine["decoder"]
        for tree in (mine, theirs):
            assert np.abs(tree["attention"]["full_att"].pop("b")).max() < 1e-8
        assert "embedding" not in mine  # frozen by default
        for key in mine:
            for g, w in zip(jax.tree_util.tree_leaves(mine[key]),
                            jax.tree_util.tree_leaves(theirs[key])):
                np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


def optax_structure_matches(chkpt, args, head=False):
    """The checkpoint's optimizer state has the tree structure of icd_tpu's
    ``tx.init(trainable)`` over the checkpoint's own trees."""
    from icd_tpu.models.encoder import trainable_mask
    from icd_tpu.training.baseline import (_decoder_trainable_mask,
                                           make_optimizer_for)
    from icd_tpu.training.common import partition

    params = {"encoder": chkpt["encoder"], "decoder": chkpt["decoder"]}
    mask = {"encoder": trainable_mask(params["encoder"], head=head),
            "decoder": _decoder_trainable_mask(params["decoder"],
                                               args.fine_tune_embedding)}
    if args.use_bert:
        mask["decoder"]["embedding"] = False
    trainable, _ = partition(params, mask)
    want = make_optimizer_for(trainable, args).init(trainable)
    return (jax.tree_util.tree_structure(chkpt["decoder_optimizer"])
            == jax.tree_util.tree_structure(want))


def test_icd_tpu_resumes_port_checkpoint(runs):
    """icd_tpu resumes training from the port's epoch-0 checkpoint, whose
    Adam state has optax's layout: its epoch-1 losses equal the port's
    own resume of the same checkpoint (rtol 1e-5, as above), and so do
    the Adam states each writes."""
    start = jax_load_checkpoint(name="tcli_p0_0.ckpt")
    assert optax_structure_matches(start, make_train_args(model="attention"))
    assert int(adam_moments(start["decoder_optimizer"])["count"]) == 2
    want = jax_load_checkpoint(name="tcli_pp_1.ckpt")
    got = jax_load_checkpoint(name="tcli_pj_1.ckpt")
    w_losses, g_losses = (c["metrics"]["epoch_losses"] for c in (want, got))
    assert len(g_losses) == len(w_losses) == 2
    assert g_losses[0] == w_losses[0]
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=1e-5)
    assert optax_structure_matches(want, make_train_args(model="attention"))
    mine, theirs = (adam_moments(c["decoder_optimizer"]) for c in (want, got))
    assert int(mine["count"]) == int(theirs["count"]) == 4
    for key in ("mu", "nu"):
        for tree in (mine[key], theirs[key]):
            tree["decoder"]["attention"]["full_att"].pop("b")
        for g, w in zip(jax.tree_util.tree_leaves(mine[key]),
                        jax.tree_util.tree_leaves(theirs[key])):
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


def test_eval_of_port_checkpoint_matches_icd_tpu(runs):
    got, want = runs["port_metrics"], runs["jax_metrics"]
    np.testing.assert_allclose(got.pop("losses"), want.pop("losses"),
                               rtol=1e-5)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"}
    assert got == {k: float(v) for k, v in want.items()}
    assert runs["eval_lines"][0] == "Loading checkpoint {}".format(
        os.path.join(runs["root"], "checkpoints", "tcli_pt_1.ckpt"))
    assert "Started validation..." in runs["eval_lines"]


def test_port_trains_from_scratch(runs, monkeypatch):
    """Epoch 0 from random weights (the port's own generator) writes a
    checkpoint that icd_tpu loads and evaluates."""
    monkeypatch.setenv("ICD_TPU_ROOT", runs["root"])
    monkeypatch.setattr(ta, "init_encoder_attention", _small_port_encoder)
    monkeypatch.setattr(ta, "init_attention_decoder", functools.partial(
        init_attention_decoder, encoder_dim=SMALL_DIM))
    lines = _run(port_train.main, ["tcli_new"] + _flags(
        decoder_dropout=0.5))
    assert _loss_lines(lines)[0].startswith("Epoch 1/1, Batch 1/2, Loss ")
    chkpt = jax_load_checkpoint(name="tcli_new_0.ckpt")
    assert chkpt["config"]["model"] == "attention"
    assert all(np.isfinite(chkpt["metrics"]["epoch_losses"][0]))
    metrics = jax_ta.evaluate(make_train_args(), chkpt["encoder"],
                              chkpt["decoder"])
    assert len(metrics["losses"]) == 4


@pytest.mark.parametrize("threshold", [1, 2])
def test_init_vocab_matches_icd_tpu(coco_root, tmp_path, monkeypatch,
                                    threshold):
    shutil.copytree(os.path.join(coco_root, "cocoapi", "annotations"),
                    tmp_path / "cocoapi" / "annotations")
    monkeypatch.setenv("ICD_TPU_ROOT", str(tmp_path))
    _run(port_init.main, ["--vocab", "True", "--vocab_threshold",
                          str(threshold)])
    got = jax_load_vocab()
    want = jax_build_vocab(threshold=threshold)
    assert got.w2i == want.w2i and got.i2w == want.i2w


def test_unported_train_options_raise(coco_root, tmp_path, monkeypatch):
    """A present models/resnet101.pth, which raised before its conversion
    was ported, is now the trunk the port's train CLI starts from: the
    checkpoint's backbone holds the file's convolutions (the trunk is
    frozen) and its BN parameters."""
    import torch

    from icd_tpu_torch.export import resnet_to_torch_state_dict
    from icd_tpu_torch.params import resnet_to_jax

    for part in (("cocoapi", "annotations"), ("cocoapi", "images"),
                 ("pkldata",)):
        shutil.copytree(os.path.join(coco_root, *part),
                        tmp_path.joinpath(*part))
    tree = resnet_to_jax(init_resnet(torch.Generator().manual_seed(5),
                                     SMALL_DEPTHS, SMALL_WIDTHS,
                                     device="cpu"))
    (tmp_path / "models").mkdir()
    torch.save(resnet_to_torch_state_dict(tree),
               str(tmp_path / "models" / "resnet101.pth"))
    monkeypatch.setenv("ICD_TPU_ROOT", str(tmp_path))
    monkeypatch.setattr(ta, "init_encoder_attention", _small_port_encoder)
    monkeypatch.setattr(ta, "init_attention_decoder", functools.partial(
        init_attention_decoder, encoder_dim=SMALL_DIM))
    lines = _run(port_train.main, ["tcli_no"] + _flags())
    assert "Loading pretrained ResNet-101 from {}".format(
        os.path.join(str(tmp_path), "models", "resnet101.pth")) in lines
    got = jax_load_checkpoint(name="tcli_no_0.ckpt")["encoder"]["resnet"]
    np.testing.assert_array_equal(got["stem"]["conv"], tree["stem"]["conv"])
    for g, w in zip(jax.tree_util.tree_leaves(got["layers"]),
                    jax.tree_util.tree_leaves(tree["layers"])):
        if g.ndim == 4:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["stem"]["bn"]["scale"],
                                  tree["stem"]["bn"]["scale"])
