"""``--use_bert`` training and teacher-forced eval of the attention
captioner (icd_tpu_torch models/attention.py's ``embeddings`` input,
training/attention.py, training/common.py, the train and eval CLIs)
against icd_tpu's, f32 and ``--amp`` on the CPU, dropout 0.

Tolerances, and why (as tests/test_torch_train.py and
tests/test_torch_train_baseline.py state them): the teacher-forced
forward's logits atol 2e-5 and alphas 5e-6; f32 train steps' losses rtol
1e-5, Adam's moments 1e-4 of each tensor's largest value, the decoders
within 1e-2 lr a step but for at most 1 % of their elements, which are
held to Adam's own bound, 2 lr a step. Adam steps an element by
lr g / (|g| + eps); BERT-scale embeddings (unit variance) leave a few
gradient elements within a few eps of zero (the score bias's gradient
is zero in exact arithmetic), where the devices' last-bit difference of
g (about 1e-6 of the tensor's largest gradient) becomes several per
cent of a step (measured: 1 element of 683 at 2.7 %). An ``--amp``
step's loss within 1e-2 and at most 10 % of the updated elements more
than lr / 100 from JAX's (XLA's CPU backend keeps chains of bf16
elementwise operations in f32, the port rounds after each). The
embedding table never moves: bit-identical.

The CLI fixture builds a ``tools/make_tiny_bert.py`` directory (hidden
768, 2 layers, a vocab.txt from the fixture's captions) and points
``BERT_MODEL_DIR`` at it. The port's CLI trains epoch 0; icd_tpu and the
port's CLI resume epoch 1 from that checkpoint (icd_tpu's BERT forward
is XLA's, the port's its own: per-batch losses rtol 1e-5); both
evaluate the port's epoch-1 checkpoint with BERT on the CPU (losses rtol
1e-5, equal predictions and scores).

Sizes: a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16) (D = 64), 64x64
images, A = 10, H = 12, E = 16, V = 29 for the steps; the CLI at the
fixture's small trunk, A = 10, H = 12, E = 768.
"""

import contextlib
import functools
import io
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icd_tpu.training.attention as jax_ta
from icd_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from icd_tpu.models.attention import (
    attention_decoder_forward as jax_decoder_forward)
from icd_tpu.models.encoder import trainable_mask as jax_trainable_mask
from icd_tpu.training.baseline import (_decoder_trainable_mask,
                                       make_optimizer_for)
from icd_tpu.training.common import merge, partition
import icd_tpu_torch.training.attention as ta
from icd_tpu_torch import eval as port_eval
from icd_tpu_torch import train as port_train
from icd_tpu_torch.models.attention import (attention_decoder_forward,
                                            init_attention_decoder)
from icd_tpu_torch.models.encoder import EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.params import (adam_moments, adam_state_to_jax,
                                  decoder_from_jax, decoder_to_jax,
                                  encoder_from_jax)
from icd_tpu_torch.training.common import make_adam
from helpers import SMALL_DEPTHS, SMALL_DIM, SMALL_WIDTHS, make_train_args
from test_torch_params import small_resnet_tree
from test_torch_qlinear import np_decoder_tree
from test_torch_train_cli import optax_structure_matches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, A, H, E, D = 29, 10, 12, 16, 64
BF16 = torch.bfloat16


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _inputs(seed, b=4, t=7):
    """Images, captions, uniform decode lengths and (B, T + 1, E) caption
    embeddings, as BERT gives them."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
    captions = rng.integers(0, V, (b, t)).astype(np.int32)
    lens = np.full(b, t - 1, np.int32)
    emb = rng.standard_normal((b, t + 1, E)).astype(np.float32)
    return imgs, captions, lens, emb


def test_decoder_forward_with_embeddings_matches_jax():
    """The first T - 1 rows of the embeddings replace the table lookup:
    the table is never read."""
    tree = np_decoder_tree(V, A, H, E, D)
    grid = np.random.default_rng(3).standard_normal((4, 3, 5, D)).astype(
        np.float32)
    _, captions, lens, emb = _inputs(1)
    lens[1:] = [4, 2, 0]
    want_p, want_a = jax_decoder_forward(
        _jax(tree), jnp.asarray(grid), jnp.asarray(captions),
        jnp.asarray(lens), embeddings=jnp.asarray(emb))
    decoder = decoder_from_jax(tree)
    with torch.no_grad():
        decoder.embedding.weight.fill_(float("nan"))
        preds, alphas = attention_decoder_forward(
            decoder, torch.from_numpy(grid), torch.from_numpy(captions).long(),
            torch.from_numpy(lens), embeddings=torch.from_numpy(emb))
    np.testing.assert_allclose(preds.numpy(), want_p, atol=2e-5)
    np.testing.assert_allclose(alphas.numpy(), want_a, atol=5e-6)


@pytest.mark.parametrize("flip", [False, True])
def test_relu_branches_record_and_replay(flip):
    """``testing.ReluBranches`` (chip_smoke's train_bert_step_f32 gives the
    card the CPU's branches with it): recording changes no gradient, one
    mask a decode step; replayed unchanged, the gradients are the same
    and no element counts as flipped; with one recorded element turned
    off, exactly that element counts and enc_att's gradient moves."""
    from icd_tpu_torch.testing import ReluBranches, decoder_grads

    decoder = decoder_from_jax(np_decoder_tree(V, A, H, E, D))
    grid = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 15, D)).astype(np.float32))
    _, captions, lens, emb = _inputs(2)
    args = (decoder, grid, torch.from_numpy(captions).long(),
            torch.from_numpy(lens), "cpu")
    plain = decoder_grads(*args, embeddings=torch.from_numpy(emb))
    branches = ReluBranches()
    grads = [decoder_grads(*args, embeddings=torch.from_numpy(emb),
                           branches=branches) for _ in range(2)]
    assert len(branches.masks) == captions.shape[1] - 1
    assert branches.flipped == 0
    for got in grads:
        for name, g in plain.items():
            torch.testing.assert_close(got[name], g, rtol=0, atol=0)
    if flip:
        on = branches.masks[2].nonzero()[0]
        branches.masks[2][tuple(on)] = False
        moved = decoder_grads(*args, embeddings=torch.from_numpy(emb),
                              branches=branches)
        assert branches.flipped == 1
        assert not torch.equal(moved["attention.enc_att.weight"],
                               plain["attention.enc_att.weight"])


def _setups(args, compute_dtype=None):
    """icd_tpu's train state and jitted step with the BERT mask (the
    table frozen, train.py:190-192), and the port's from the same
    trees."""
    enc_tree = {"resnet": small_resnet_tree()}
    dec_tree = np_decoder_tree(V, A, H, E, D)
    params = {"encoder": _jax(enc_tree), "decoder": _jax(dec_tree)}
    mask = {"encoder": jax_trainable_mask(params["encoder"], fine_tune=False,
                                          head=False),
            "decoder": _decoder_trainable_mask(params["decoder"],
                                               args.fine_tune_embedding)}
    mask["decoder"]["embedding"] = False
    trainable, frozen = partition(params, mask)
    tx = make_optimizer_for(trainable, args)
    jax_step = jax.jit(jax_ta.make_train_step(
        mask, tx, args.alpha_c, args.decoder_dropout,
        None if compute_dtype is None else jnp.bfloat16))
    encoder, decoder = encoder_from_jax(enc_tree), decoder_from_jax(dec_tree)
    optimizer = make_adam(args, encoder, decoder, None)
    step = ta.make_train_step(encoder, decoder, optimizer, args.alpha_c,
                              args.decoder_dropout, args.grad_clip,
                              compute_dtype)
    return dict(jax=[trainable, frozen, tx.init(trainable)],
                jax_step=jax_step, port=(encoder, decoder, optimizer),
                step=step, dec_tree=dec_tree)


def _run(setup, steps):
    """The same steps through both; (port losses, JAX losses)."""
    got, want = [], []
    for i in range(steps):
        imgs, captions, lens, emb = _inputs(10 + i, t=6 + i)
        trainable, frozen, opt_state = setup["jax"]
        trainable, frozen, opt_state, loss = setup["jax_step"](
            trainable, frozen, opt_state, jax.random.PRNGKey(0),
            jnp.asarray(imgs), jnp.asarray(captions), jnp.asarray(lens),
            jnp.asarray(emb))
        setup["jax"] = [trainable, frozen, opt_state]
        want.append(float(loss))
        got.append(setup["step"](
            torch.from_numpy(imgs), torch.from_numpy(captions),
            torch.from_numpy(lens), None, torch.from_numpy(emb)).item())
    return got, want


@pytest.mark.parametrize("steps", [1, 2])
def test_bert_train_steps_match_jax(steps):
    """f32, dropout 0, grad_clip 0.02 (bites), --fine_tune_embedding set:
    with --use_bert the table stays frozen anyway. Loss, decoder, Adam."""
    args = make_train_args(model="attention", decoder_dropout=0.0,
                           grad_clip=0.02, decoder_lr=1e-3, use_bert=True,
                           fine_tune_embedding=True)
    setup = _setups(args)
    got, want = _run(setup, steps)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    encoder, decoder, optimizer = setup["port"]
    trainable, frozen, opt_state = setup["jax"]
    full = jax.tree_util.tree_map(np.asarray, merge(trainable, frozen))
    lr = args.decoder_lr
    mine = decoder_to_jax(decoder)
    np.testing.assert_array_equal(mine.pop("embedding"),
                                  setup["dec_tree"]["embedding"])
    want_dec = dict(full["decoder"])
    want_dec.pop("embedding")
    theirs = adam_moments(jax.tree_util.tree_map(np.asarray, opt_state))
    beyond = total = 0
    for g, w in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(want_dec)):
        np.testing.assert_allclose(g, w, atol=2 * lr * steps)
        beyond += int((np.abs(g - w) > 1e-2 * lr * steps).sum())
        total += g.size
    assert beyond <= 0.01 * total, (beyond, total)

    state = adam_state_to_jax(optimizer, decoder)
    assert "embedding" not in state["mu"]["decoder"]
    assert int(state["count"]) == int(theirs["count"]) == steps
    for key in ("mu", "nu"):
        for tree in (state[key], theirs[key]):
            noise = tree["decoder"]["attention"]["full_att"].pop("b")
            assert np.abs(noise).max() < 1e-8
        want_tree = theirs[key]
        assert set(state[key]["decoder"]) == set(want_tree["decoder"])
        for g, w in zip(jax.tree_util.tree_leaves(state[key]),
                        jax.tree_util.tree_leaves(want_tree)):
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


def test_bert_amp_step_matches_jax():
    """One --amp step on bf16 embeddings (cast as JAX casts them): the
    loss within 1e-2, at most 10 % of the updated elements more than
    lr / 100 from JAX's, f32 masters, the table bit-identical."""
    args = make_train_args(model="attention", decoder_dropout=0.0,
                           decoder_lr=1e-3, grad_clip=5.0, use_bert=True)
    setup = _setups(args, BF16)
    (got,), (want,) = _run(setup, 1)
    assert abs(got - want) / abs(want) <= 1e-2, (got, want)
    _, decoder, optimizer = setup["port"]
    assert all(p.dtype == torch.float32 for p in decoder.parameters())
    assert all(s["exp_avg"].dtype == torch.float32
               for s in optimizer.state.values())
    trainable, frozen, _ = setup["jax"]
    full = jax.tree_util.tree_map(np.asarray, merge(trainable, frozen))
    mine = decoder_to_jax(decoder)
    np.testing.assert_array_equal(mine["embedding"],
                                  setup["dec_tree"]["embedding"])
    g = jax.tree_util.tree_leaves(mine)
    w = jax.tree_util.tree_leaves(full["decoder"])
    beyond = sum(int((np.abs(a - b) > args.decoder_lr / 100).sum())
                 for a, b in zip(g, w))
    assert beyond / sum(a.size for a in g) <= 0.1


def test_bert_eval_step_matches_jax():
    """The eval step on caption embeddings: per-sample losses rtol 1e-5,
    argmax predictions equal."""
    enc_tree = {"resnet": small_resnet_tree()}
    dec_tree = np_decoder_tree(V, A, H, E, D)
    imgs, captions, _, emb = _inputs(20)
    lens = np.array([6, 4, 3, 1], np.int32)
    want_loss, want_pred = jax_ta.make_eval_step()(
        _jax(enc_tree), _jax(dec_tree), jnp.asarray(imgs),
        jnp.asarray(captions), jnp.asarray(lens), jnp.asarray(emb))
    step = ta.make_eval_step(encoder_from_jax(enc_tree),
                             decoder_from_jax(dec_tree))
    loss, pred = step(torch.from_numpy(imgs), torch.from_numpy(captions),
                      torch.from_numpy(lens), torch.from_numpy(emb))
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), want_pred)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

SIZES = dict(batch_size=4, embed_size=768, decoder_dim=12, attention_dim=10,
             workers=0, decoder_dropout=0.0)


def _flags(**kw):
    out = ["--model", "attention", "--use_bert", "True", "--device", "cpu"]
    for key, value in dict(SIZES, **kw).items():
        out += ["--" + key, str(value)]
    return out


def _lines(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def _small_port_encoder(generator, dtype=None, device=None):
    return EncoderAttention(init_resnet(generator, SMALL_DEPTHS,
                                        SMALL_WIDTHS, device=device))


@pytest.fixture(scope="module")
def runs(coco_root, tmp_path_factory):
    bert_dir = str(tmp_path_factory.mktemp("tinybert768"))
    mp = pytest.MonkeyPatch()
    mp.setenv("ICD_TPU_ROOT", coco_root)
    mp.setenv("ICD_TPU_METEOR_PY", "1")
    mp.setattr(sys, "argv", ["make_tiny_bert.py", bert_dir])
    mp.setattr(ta, "init_encoder_attention", _small_port_encoder)
    mp.setattr(ta, "init_attention_decoder", functools.partial(
        init_attention_decoder, encoder_dim=SMALL_DIM))
    try:
        _lines(runpy.run_path, os.path.join(REPO, "tools", "make_tiny_bert.py"),
               run_name="__main__")
        mp.setenv("BERT_MODEL_DIR", bert_dir)
        _lines(port_train.main, ["bert_p0"] + _flags())
        _lines(jax_ta.train, make_train_args(
            model="attention", model_name="bert_pj", epochs=2,
            checkpoint="bert_p0_0.ckpt", use_bert=True, **SIZES))
        port_lines = _lines(port_train.main, ["bert_pp"] + _flags(
            epochs=2, checkpoint="bert_p0_0.ckpt"))
        chkpt = jax_load_checkpoint(name="bert_pp_1.ckpt")
        jax_metrics = jax_ta.evaluate(
            make_train_args(checkpoint="bert_pp_1.ckpt"), chkpt["encoder"],
            chkpt["decoder"], use_bert=True)
        eval_lines = _lines(port_eval.main, [
            "bert_pp_1.ckpt", "--model_type", "attention", "--device", "cpu"])
        with open(os.path.join(coco_root, "eval_data",
                               "bert_pp_1.json")) as f:
            port_metrics = json.load(f)
        yield dict(port_lines=port_lines, jax_metrics=jax_metrics,
                   port_metrics=port_metrics, eval_lines=eval_lines)
    finally:
        mp.undo()


def test_use_bert_cli_resume_matches_icd_tpu(runs):
    """The port's --use_bert epoch 0 resumes in icd_tpu (its Adam state
    has optax's layout, the table frozen) and in the port: the same
    epoch-1 losses; the table never moved."""
    start = jax_load_checkpoint(name="bert_p0_0.ckpt")
    assert start["config"]["use_bert"] is True
    args = make_train_args(model="attention", use_bert=True)
    assert optax_structure_matches(start, args)
    want = jax_load_checkpoint(name="bert_pp_1.ckpt")
    got = jax_load_checkpoint(name="bert_pj_1.ckpt")
    w_losses, g_losses = (c["metrics"]["epoch_losses"] for c in (want, got))
    assert len(g_losses) == len(w_losses) == 2
    assert g_losses[0] == w_losses[0]
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=1e-5)
    assert all(np.isfinite(w_losses[1]))
    for c in (want, got):
        np.testing.assert_array_equal(c["decoder"]["embedding"],
                                      start["decoder"]["embedding"])
    assert "Model bert_pp finished training for 2 epochs." in runs[
        "port_lines"]


def test_use_bert_eval_matches_icd_tpu(runs):
    got, want = dict(runs["port_metrics"]), dict(runs["jax_metrics"])
    np.testing.assert_allclose(got.pop("losses"), want.pop("losses"),
                               rtol=1e-5)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"}
    assert got == {k: float(v) for k, v in want.items()}
    assert "Started validation..." in runs["eval_lines"]
