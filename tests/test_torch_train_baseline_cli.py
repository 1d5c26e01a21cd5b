"""``python -m icd_tpu_torch.{train,eval} --model[_type] baseline``
against icd_tpu's baseline drivers on the ``coco_root`` fixture (8 train
captions, 4 val captions), f32 on the CPU; and ``--amp`` /
``--int8_encoder`` through the port's train CLI for both families.

One module fixture runs icd_tpu's ``training.baseline.train`` for epoch
0 (a (1, 1, 1, 1) ResNet of widths (4, 4, 8, 8) with a Linear(32, 16)
head, E = 16, H = 12, batch 4, the head trained with
``--fine_tune_encoder``), then resumes epoch 1 from that checkpoint
twice: with icd_tpu and with the port's CLI. Then both evaluate the
port's epoch-1 checkpoint. Then the port's CLI trains epoch 0 from its
own random weights, and both packages resume epoch 1 from that
checkpoint. icd_tpu pads the captions to a multiple of
8, the port to the batch's longest: under the pad mask the losses are
the same.

Tolerances, and why: the port and XLA sum in other orders, so the
per-batch losses agree to rtol 1e-5 and their printed lines (4
decimals) are equal; the saved decoders and heads to atol 1e-2 * lr per
step (tests/test_torch_train.py: a gradient element near Adam's eps
turns its rounding into up to 1e-2 of a step); Adam's moments to 1e-4 of
each tensor's largest value. Eval: per-sample losses rtol 1e-5; the
argmax hypotheses are equal, so the references and hypotheses handed to
the scorers are equal and so are Bleu_1-4, METEOR (the pure-Python
backend, ``ICD_TPU_METEOR_PY=1``), ROUGE_L and CIDEr.
"""

import contextlib
import functools
import io
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import icd_tpu.models.attention as jax_ma
import icd_tpu.training.attention as jax_ta
import icd_tpu.training.baseline as jax_tb
import icd_tpu_torch.training.attention as ta
import icd_tpu_torch.training.baseline as tb
from icd_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from icd_tpu_torch import eval as port_eval
from icd_tpu_torch import train as port_train
from icd_tpu_torch.models.attention import init_attention_decoder
from icd_tpu_torch.models.encoder import Encoder, EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.params import adam_moments
from test_torch_train_cli import optax_structure_matches
from helpers import (SMALL_DEPTHS, SMALL_DIM, SMALL_WIDTHS, make_train_args,
                     small_init_encoder, small_init_encoder_attention)

SIZES = dict(batch_size=4, embed_size=16, decoder_dim=12, workers=0)
ATT_SIZES = dict(SIZES, attention_dim=10, decoder_dropout=0.0)
LR = 1e-4  # the CLI's default rates


def _flags(model, sizes, **kw):
    out = ["--model", model, "--device", "cpu"]
    for key, value in dict(sizes, **kw).items():
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


def _small_encoder(generator, embed_size, dtype=None, device=None):
    """The port's ``init_encoder`` at the small backbone's width."""
    embed = torch.nn.Linear(SMALL_DIM, embed_size)
    bound = 1.0 / math.sqrt(SMALL_DIM)
    with torch.no_grad():
        for p in (embed.weight, embed.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound)
                    - bound)
    return Encoder(init_resnet(generator, SMALL_DEPTHS, SMALL_WIDTHS,
                               device=device), embed.to(device))


def _small_encoder_attention(generator, dtype=None, device=None):
    return EncoderAttention(init_resnet(generator, SMALL_DEPTHS,
                                        SMALL_WIDTHS, device=device))


def _recording(scored, get_eval_score):
    """``get_eval_score`` that also keeps what it was given."""
    def score(references, hypotheses):
        scored.append((references, hypotheses))
        return get_eval_score(references, hypotheses)
    return score


# The port's --amp and --int8_encoder runs: (model name, model, flags).
PRECISION_RUNS = [
    ("bamp", "baseline", dict(amp=True, fine_tune_encoder=True)),
    ("bint8", "baseline", dict(int8_encoder=True, epochs=2)),
    ("aamp", "attention", dict(amp=True)),
    ("aint8", "attention", dict(int8_encoder=True, amp=True, epochs=2)),
]


@pytest.fixture(scope="module")
def runs(coco_root):
    mp = pytest.MonkeyPatch()
    mp.setenv("ICD_TPU_ROOT", coco_root)
    mp.setenv("ICD_TPU_METEOR_PY", "1")
    mp.setattr(jax_tb, "init_encoder", small_init_encoder)
    mp.setattr(tb, "init_encoder", _small_encoder)
    mp.setattr(jax_ta, "init_encoder_attention",
               small_init_encoder_attention)
    mp.setattr(jax_ta, "init_attention_decoder", functools.partial(
        jax_ma.init_attention_decoder, encoder_dim=SMALL_DIM))
    mp.setattr(ta, "init_encoder_attention", _small_encoder_attention)
    mp.setattr(ta, "init_attention_decoder", functools.partial(
        init_attention_decoder, encoder_dim=SMALL_DIM))
    jax_scored, port_scored = [], []
    mp.setattr(jax_tb, "get_eval_score",
               _recording(jax_scored, jax_tb.get_eval_score))
    mp.setattr(tb, "get_eval_score",
               _recording(port_scored, tb.get_eval_score))
    try:
        jax_args = dict(SIZES, model="baseline", model_name="bcli_jx",
                        fine_tune_encoder=True)
        jax_tb.train(make_train_args(**jax_args))
        jax_lines = _run(jax_tb.train, make_train_args(
            **dict(jax_args, epochs=2, checkpoint="bcli_jx_0.ckpt")))
        port_lines = _run(port_train.main, ["bcli_pt"] + _flags(
            "baseline", SIZES, epochs=2, checkpoint="bcli_jx_0.ckpt",
            fine_tune_encoder=True))
        args = make_train_args(model_name="bcli_pt",
                               checkpoint="bcli_pt_1.ckpt")
        chkpt = jax_load_checkpoint(name="bcli_pt_1.ckpt")
        jax_metrics = jax_tb.evaluate(args, chkpt["encoder"],
                                      chkpt["decoder"])
        eval_lines = _run(port_eval.main, ["bcli_pt_1.ckpt", "--model_type",
                                           "baseline", "--device", "cpu"])
        with open(os.path.join(coco_root, "eval_data",
                               "bcli_pt_1.json")) as f:
            port_metrics = json.load(f)
        _run(port_train.main, ["bcli_p0"] + _flags(
            "baseline", SIZES, fine_tune_encoder=True))
        _run(jax_tb.train, make_train_args(**dict(
            jax_args, model_name="bcli_pj", epochs=2,
            checkpoint="bcli_p0_0.ckpt")))
        _run(port_train.main, ["bcli_pp"] + _flags(
            "baseline", SIZES, epochs=2, checkpoint="bcli_p0_0.ckpt",
            fine_tune_encoder=True))
        precision = {}
        for name, model, kw in PRECISION_RUNS:
            sizes = SIZES if model == "baseline" else ATT_SIZES
            precision[name] = _run(port_train.main,
                                   [name] + _flags(model, sizes, **kw))
        yield dict(root=coco_root, jax_lines=jax_lines,
                   port_lines=port_lines, jax_metrics=jax_metrics,
                   port_metrics=port_metrics, eval_lines=eval_lines,
                   scored=(jax_scored, port_scored), precision=precision)
    finally:
        mp.undo()


def test_resume_from_icd_tpu_baseline_checkpoint_matches_icd_tpu(runs):
    want = jax_load_checkpoint(name="bcli_jx_1.ckpt")
    got = jax_load_checkpoint(name="bcli_pt_1.ckpt")
    assert got["epoch"] == want["epoch"] == 1
    assert got["config"]["model"] == "baseline"
    w_losses, g_losses = (c["metrics"]["epoch_losses"] for c in (want, got))
    assert len(g_losses) == len(w_losses) == 2
    assert g_losses[0] == w_losses[0]  # epoch 0, carried over
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=1e-5)
    assert _loss_lines(runs["port_lines"]) == _loss_lines(runs["jax_lines"])
    assert runs["port_lines"][-1].startswith(
        "Model bcli_pt finished training for 2 epochs in ")

    for g, w in zip(jax.tree_util.tree_leaves(got["decoder"]),
                    jax.tree_util.tree_leaves(want["decoder"])):
        np.testing.assert_allclose(g, w, atol=1e-2 * LR * 2)
    np.testing.assert_array_equal(got["decoder"]["embedding"],
                                  want["decoder"]["embedding"])
    for g, w in zip(jax.tree_util.tree_leaves(got["encoder"]["embed"]),
                    jax.tree_util.tree_leaves(want["encoder"]["embed"])):
        np.testing.assert_allclose(g, w, atol=1e-2 * LR * 2)
    # The frozen trunk: equal weights, train-mode BN statistics close.
    for g, w in zip(jax.tree_util.tree_leaves(got["encoder"]["resnet"]),
                    jax.tree_util.tree_leaves(want["encoder"]["resnet"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)

    # Adam: the port's state (read back to its numpy form) against
    # optax's two groups.
    state = adam_moments(got["decoder_optimizer"])
    groups = want["decoder_optimizer"].inner_states
    assert int(state["count"]) == 4
    for group, keys in (("decoder", ("lstm", "linear")),
                        ("encoder", ("embed",))):
        adam = groups[group].inner_state[1][0]
        assert int(adam.count) == 4
        for mine, theirs in ((state["mu"], adam.mu), (state["nu"], adam.nu)):
            assert set(mine[group]) == set(keys)  # the embedding is frozen
            for key in keys:
                for g, w in zip(jax.tree_util.tree_leaves(mine[group][key]),
                                jax.tree_util.tree_leaves(
                                    theirs[group][key])):
                    np.testing.assert_allclose(
                        g, w, atol=1e-4 * np.abs(w).max())


def test_eval_of_port_baseline_checkpoint_matches_icd_tpu(runs):
    got, want = runs["port_metrics"], runs["jax_metrics"]
    np.testing.assert_allclose(got.pop("losses"), want.pop("losses"),
                               rtol=1e-5)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"}
    assert got == {k: float(v) for k, v in want.items()}
    (want_refs, want_hyps), = runs["scored"][0]
    (got_refs, got_hyps), = runs["scored"][1]
    assert len(got_refs) == 4
    assert got_refs == want_refs and got_hyps == want_hyps
    # References repeat the cleaned caption once per caption token.
    assert all(len(refs) > 2 and all(r == refs[0] for r in refs)
               for refs in got_refs)
    assert runs["eval_lines"][0] == "Loading checkpoint {}".format(
        os.path.join(runs["root"], "checkpoints", "bcli_pt_1.ckpt"))
    assert "Started validation..." in runs["eval_lines"]


def test_icd_tpu_resumes_port_baseline_checkpoint(runs):
    """icd_tpu resumes training from the port's epoch-0 baseline
    checkpoint (the head trained, so both optax groups hold moments):
    its epoch-1 losses equal the port's own resume of the same checkpoint
    (rtol 1e-5, as above), and so do the Adam states each writes."""
    args = make_train_args(model="baseline", fine_tune_encoder=True)
    start = jax_load_checkpoint(name="bcli_p0_0.ckpt")
    assert optax_structure_matches(start, args, head=True)
    want = jax_load_checkpoint(name="bcli_pp_1.ckpt")
    got = jax_load_checkpoint(name="bcli_pj_1.ckpt")
    w_losses, g_losses = (c["metrics"]["epoch_losses"] for c in (want, got))
    assert len(g_losses) == len(w_losses) == 2
    assert g_losses[0] == w_losses[0]
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=1e-5)
    assert optax_structure_matches(want, args, head=True)
    mine, theirs = (adam_moments(c["decoder_optimizer"]) for c in (want, got))
    assert int(mine["count"]) == int(theirs["count"]) == 4
    for key in ("mu", "nu"):
        assert set(mine[key]) == set(theirs[key]) == {"encoder", "decoder"}
        for g, w in zip(jax.tree_util.tree_leaves(mine[key]),
                        jax.tree_util.tree_leaves(theirs[key])):
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


def _float32_trees(chkpt):
    adam = adam_moments(chkpt["decoder_optimizer"])
    leaves = jax.tree_util.tree_leaves(
        [chkpt["encoder"], chkpt["decoder"], adam["mu"], adam["nu"]])
    return leaves and all(np.asarray(x).dtype == np.float32 for x in leaves)


def _bn_stats(tree):
    return [x for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]
            if path[-1].key in ("mean", "var")]


@pytest.mark.parametrize("name,model,kw", PRECISION_RUNS,
                         ids=[r[0] for r in PRECISION_RUNS])
def test_amp_and_int8_train_through_the_cli(runs, name, model, kw):
    """The port's --amp and --int8_encoder runs of each family: finite
    losses, f32 checkpoints (weights and Adam moments); under
    --int8_encoder the BN statistics moved in the warm-up and then stayed
    as they were through both epochs; without it they move every
    epoch."""
    epochs = kw.get("epochs", 1)
    lines = runs["precision"][name]
    assert len(_loss_lines(lines)) == 2 * epochs
    chkpts = [jax_load_checkpoint(name="{}_{}.ckpt".format(name, e))
              for e in range(epochs)]
    for chkpt in chkpts:
        assert chkpt["config"]["model"] == model
        assert all(math.isfinite(x) for e in chkpt["metrics"]["epoch_losses"]
                   for x in e)
        assert _float32_trees(chkpt)
    stats = _bn_stats(chkpts[-1]["encoder"]["resnet"])
    # The fresh trunk's BN is the identity (mean 0, var 1).
    assert not all(np.array_equal(s, np.zeros_like(s)) or
                   np.array_equal(s, np.ones_like(s)) for s in stats)
    if kw.get("int8_encoder"):
        for a, b in zip(_bn_stats(chkpts[0]["encoder"]["resnet"]), stats):
            np.testing.assert_array_equal(a, b)
    if kw.get("fine_tune_encoder"):
        assert set(adam_moments(chkpts[-1]["decoder_optimizer"])["mu"]) == {
            "encoder", "decoder"}


@pytest.mark.parametrize("argv,match", [
    (["--model", "baseline", "--use_bert", "True", "--embed_size", "768"],
     "only used for attention"),
    (["--model", "attention", "--use_bert", "True"], "768 for BERT"),
])
def test_train_cli_checks_bert_flags(use_coco_root, argv, match):
    """The root CLI's checks: BERT only for the attention model, at
    embed_size 768."""
    with pytest.raises(ValueError, match=match):
        port_train.main(["bcli_no"] + argv + ["--device", "cpu"])
