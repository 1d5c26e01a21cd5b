"""Training of the attention captioner (icd_tpu_torch models/resnet.py
train-mode BN, models/attention.py:attention_decoder_forward,
training/common.py, training/attention.py's steps, params.py's Adam
bridge) against icd_tpu's, f32 on the CPU.

Tolerances, and why:
- train-mode BN: the port takes the batch mean and variance with
  ATen's reductions, JAX with XLA's (another summation order): rtol
  1e-5, atol 1e-5 on outputs of unit scale, and on the statistics;
- the teacher-forced forward: the port sums the attention context with
  ``bmm`` and JAX with a multiply-reduce: logits atol 2e-5, alphas atol
  5e-6 (the beam tests' alpha tolerance); masked steps exactly zero;
- train steps: losses rtol 1e-5. Gradients differ in the last bits, so
  Adam's moments do too (rtol 1e-4 against each tensor's largest
  value). An Adam step moves each element by lr * m / (sqrt(v) + eps),
  at most lr; a gradient element g near eps (1e-8) turns its rounding
  difference dg into eps * dg / (|g| + eps)^2 of the step: parameters
  within atol 1e-2 * lr per step. The score bias's gradient is zero
  in exact arithmetic, so its step is rounding noise: within lr a step;
- the eval step: per-sample losses rtol 1e-5, argmax predictions equal.

Sizes: a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16) (D = 64) with
random BN statistics, 64x64 images, A = 10, H = 12, E = 16, V = 29.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icd_tpu.training.attention as jax_ta
from icd_tpu.models.attention import (
    attention_decoder_forward as jax_decoder_forward)
from icd_tpu.models.encoder import trainable_mask as jax_trainable_mask
from icd_tpu.models.resnet import batch_norm as jax_batch_norm
from icd_tpu.models.resnet import resnet_forward as jax_resnet_forward
from icd_tpu.training.baseline import (_decoder_trainable_mask,
                                       make_optimizer_for)
from icd_tpu.training.common import cross_entropy as jax_cross_entropy
from icd_tpu.training.common import (
    doubly_stochastic_regularizer as jax_regularizer)
from icd_tpu.training.common import merge, partition
from icd_tpu_torch.checkpoint import _CheckpointUnpickler
from icd_tpu_torch.models.attention import (attention_decoder_forward,
                                            dropout)
from icd_tpu_torch.models.encoder import trainable_mask
from icd_tpu_torch.models.resnet import (BatchNorm, batch_norm_train, merge_bn_stats,
                                         resnet_forward)
from icd_tpu_torch.params import (adam_state_from_jax, adam_state_to_jax,
                                  decoder_from_jax, decoder_to_jax,
                                  encoder_from_jax, encoder_to_jax,
                                  resnet_from_jax)
from icd_tpu_torch.training.attention import (make_eval_step,
                                              make_train_step,
                                              trainable_parameters)
from icd_tpu_torch.training.common import (cross_entropy,
                                           doubly_stochastic_regularizer,
                                           make_optimizer)
from helpers import make_train_args
from test_torch_params import small_resnet_tree
from test_torch_qlinear import np_decoder_tree

V, A, H, E, D = 29, 10, 12, 16, 64


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_trees_close(got, want, rtol=0.0, atol=0.0, scaled=False):
    """Leaf by leaf; ``scaled``: atol relative to each leaf's max."""
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        tol = atol * max(np.abs(w).max(), 1e-30) if scaled else atol
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol, atol=tol)


def _inputs(b=4, t=7, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
    captions = rng.integers(0, V, (b, t)).astype(np.int32)
    if lengths is None:
        lengths = np.full(b, t - 1, np.int32)
    return imgs, captions, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("shape", [(2, 5, 5, 8), (3, 1, 1, 6), (1, 1, 1, 4)])
def test_train_batch_norm_matches_jax(shape):
    rng = np.random.default_rng(1)
    c = shape[-1]
    bn_tree = {"scale": rng.standard_normal(c).astype(np.float32),
               "bias": rng.standard_normal(c).astype(np.float32),
               "mean": rng.standard_normal(c).astype(np.float32),
               "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    want_y, want_bn = jax_batch_norm(jnp.asarray(x), _jax(bn_tree),
                                     train=True)
    bn = BatchNorm(c)
    with torch.no_grad():
        for key in bn_tree:
            getattr(bn, key).copy_(torch.from_numpy(bn_tree[key]))
    y, stats = batch_norm_train(torch.from_numpy(x), bn)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(stats[key].numpy(), want_bn[key],
                                   rtol=1e-5, atol=1e-5)
    # The module is left as it was.
    np.testing.assert_array_equal(bn.mean.numpy(), bn_tree["mean"])


def test_train_mode_resnet_matches_jax():
    tree = small_resnet_tree()
    x = np.random.default_rng(2).standard_normal((3, 64, 64, 3)).astype(
        np.float32)
    want_feats, want_tree = jax_resnet_forward(_jax(tree), jnp.asarray(x),
                                               train=True)
    net = resnet_from_jax(tree)
    with torch.no_grad():
        feats, stats = resnet_forward(net, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(feats.numpy(), want_feats, rtol=1e-4,
                               atol=1e-4)
    merge_bn_stats(stats)
    got = encoder_to_jax(type("E", (), {"resnet": net})())["resnet"]
    _assert_trees_close(got, want_tree, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fine_tune", [False, True])
def test_trainable_mask_matches_jax(fine_tune):
    tree = {"resnet": small_resnet_tree()}
    want = jax_trainable_mask(tree, fine_tune=fine_tune, head=False)
    encoder = encoder_from_jax(tree)
    mask = trainable_mask(encoder, fine_tune=fine_tune)
    for name, _ in encoder.named_parameters():
        node = want
        for part in name.split("."):
            node = node[int(part) if isinstance(node, list) else part]
        assert mask[name] == node, name


@pytest.mark.parametrize("lengths", [None, [6, 3, 1, 0]])
def test_decoder_forward_matches_jax(lengths):
    """Dropout 0, uniform and mixed decode lengths."""
    tree = np_decoder_tree(V, A, H, E, D)
    grid = np.random.default_rng(3).standard_normal((4, 3, 5, D)).astype(
        np.float32)
    _, captions, lens = _inputs(lengths=lengths)
    want_p, want_a = jax_decoder_forward(_jax(tree), jnp.asarray(grid),
                                         jnp.asarray(captions),
                                         jnp.asarray(lens))
    with torch.no_grad():
        preds, alphas = attention_decoder_forward(
            decoder_from_jax(tree), torch.from_numpy(grid),
            torch.from_numpy(captions).long(), torch.from_numpy(lens))
    assert preds.shape == (4, 6, V) and alphas.shape == (4, 6, 15)
    np.testing.assert_allclose(preds.numpy(), want_p, atol=2e-5)
    np.testing.assert_allclose(alphas.numpy(), want_a, atol=5e-6)
    masked = np.arange(6)[None, :] >= lens[:, None]
    assert not preds.numpy()[masked].any()
    assert not alphas.numpy()[masked].any()


def test_dropout_rate_rescale_and_seed():
    x = torch.ones(64, 24, 512)
    rate = 0.5

    def draw(seed):
        return dropout(x, rate, torch.Generator().manual_seed(seed))

    out = draw(1)
    dropped = (out == 0).float().mean().item()
    # 786,432 draws: the dropped share's standard deviation is 5.6e-4.
    assert abs(dropped - rate) < 5e-3
    kept = out[out != 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0 / (1.0 - rate)))
    assert torch.equal(draw(1), out)
    assert not torch.equal(draw(2), out)


@pytest.mark.parametrize("ignore_index", [None, 0])
def test_losses_match_jax(ignore_index):
    """The port's CE over each row's decode length against icd_tpu's CE
    over every position (None) or over the non-pad targets (0), with the
    pads exactly past each decode length: the same mean either way."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, V)).astype(np.float32)
    lengths = np.array([5, 5, 5] if ignore_index is None else [5, 2, 0],
                       np.int32)
    targets = rng.integers(1, 4, (3, 5)).astype(np.int32)
    targets[np.arange(5)[None, :] >= lengths[:, None]] = 0
    alphas = rng.uniform(0, 1, (3, 5, 15)).astype(np.float32)
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                             ignore_index=ignore_index)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want = jax_regularizer(jnp.asarray(alphas), 1.0)
    got = doubly_stochastic_regularizer(torch.from_numpy(alphas), 1.0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _jax_setup(enc_tree, dec_tree, args):
    """icd_tpu's train state and jitted step, built as its train() does."""
    params = {"encoder": _jax(enc_tree), "decoder": _jax(dec_tree)}
    mask = {"encoder": jax_trainable_mask(params["encoder"], fine_tune=False,
                                          head=False),
            "decoder": _decoder_trainable_mask(params["decoder"],
                                               args.fine_tune_embedding)}
    trainable, frozen = partition(params, mask)
    tx = make_optimizer_for(trainable, args)
    step = jax.jit(jax_ta.make_train_step(mask, tx, args.alpha_c,
                                          args.decoder_dropout))
    return trainable, frozen, tx.init(trainable), step


def _port_setup(enc_tree, dec_tree, args):
    encoder, decoder = encoder_from_jax(enc_tree), decoder_from_jax(dec_tree)
    enc_params, dec_params = trainable_parameters(
        encoder, decoder, args.fine_tune_embedding)
    optimizer = make_optimizer(enc_params, dec_params, args.encoder_lr,
                               args.decoder_lr)
    step = make_train_step(encoder, decoder, optimizer, args.alpha_c,
                           args.decoder_dropout, args.grad_clip)
    return encoder, decoder, optimizer, step


def _jax_adam(opt_state):
    """The decoder group's (count, mu, nu) of icd_tpu's optax state."""
    adam = opt_state.inner_states["decoder"].inner_state[1][0]
    return adam.count, adam.mu, adam.nu


def _drop_empty(tree):
    """The trainable leaves of an optax moment tree (None and optax's
    MaskedNode mark the others)."""
    if isinstance(tree, dict):
        out = {k: _drop_empty(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None} or None
    if isinstance(tree, list):
        return None if all(_drop_empty(v) is None for v in tree) else tree
    return tree if hasattr(tree, "shape") else None


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_jax(steps):
    """f32, dropout 0, grad_clip 0.02 (it bites: the largest gradient
    element is checked to exceed it); the embedding frozen as by
    default. Loss, decoder, Adam count/mu/nu, new BN statistics."""
    args = make_train_args(model="attention", decoder_dropout=0.0,
                           grad_clip=0.02, decoder_lr=1e-3, alpha_c=1.0)
    enc_tree = {"resnet": small_resnet_tree()}
    dec_tree = np_decoder_tree(V, A, H, E, D)
    trainable, frozen, opt_state, jax_step = _jax_setup(enc_tree, dec_tree,
                                                        args)
    encoder, decoder, optimizer, step = _port_setup(enc_tree, dec_tree,
                                                    args)
    rng_key = jax.random.PRNGKey(0)
    for i in range(steps):
        imgs, captions, lens = _inputs(seed=10 + i, t=6 + i)
        trainable, frozen, opt_state, want_loss = jax_step(
            trainable, frozen, opt_state, rng_key, jnp.asarray(imgs),
            jnp.asarray(captions), jnp.asarray(lens))
        loss = step(torch.from_numpy(imgs), torch.from_numpy(captions),
                    torch.from_numpy(lens))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        if i == 0:
            # Clipping bit: some elements sit exactly at the clip value.
            clip = torch.tensor(args.grad_clip, dtype=torch.float32)
            assert any(bool((p.grad.abs() == clip).any())
                       for p in decoder.parameters() if p.grad is not None)
            assert decoder.embedding.weight.grad is None

    full = jax.tree_util.tree_map(np.asarray, merge(trainable, frozen))
    lr = args.decoder_lr
    got = decoder_to_jax(decoder)
    # The score bias's gradient is zero in exact arithmetic (the softmax
    # ignores a shift of every score), so its Adam step is rounding
    # noise over eps on both sides: anywhere within lr a step.
    np.testing.assert_allclose(got["attention"]["full_att"].pop("b"),
                               full["decoder"]["attention"]["full_att"]
                               .pop("b"), atol=lr * steps)
    _assert_trees_close(got, full["decoder"], atol=1e-2 * lr * steps)
    np.testing.assert_array_equal(decoder.embedding.weight.numpy(),
                                  dec_tree["embedding"])
    _assert_trees_close(encoder_to_jax(encoder), full["encoder"],
                        rtol=1e-5, atol=1e-5)

    count, mu, nu = _jax_adam(opt_state)
    state = adam_state_to_jax(optimizer, decoder)
    assert int(state["count"]) == int(count) == steps
    for got, want in ((state["mu"], mu), (state["nu"], nu)):
        want = _drop_empty(jax.tree_util.tree_map(np.asarray, want))
        # The score bias's moments: rounding noise on both sides.
        for tree in (got, want):
            noise = tree["decoder"]["attention"]["full_att"].pop("b")
            assert np.abs(noise).max() < 1e-8
        _assert_trees_close(got, want, rtol=1e-4, atol=1e-4, scaled=True)


def test_adam_state_from_icd_tpu_checkpoint():
    """An optax state pickled by icd_tpu, read back through the port's
    unpickler (optax classes become inert stand-ins), becomes Adam state
    equal to the JAX moments, and the port's own form round-trips."""
    args = make_train_args(model="attention", decoder_dropout=0.0,
                           fine_tune_embedding=True)
    enc_tree = {"resnet": small_resnet_tree()}
    dec_tree = np_decoder_tree(V, A, H, E, D)
    trainable, frozen, opt_state, jax_step = _jax_setup(enc_tree, dec_tree,
                                                        args)
    imgs, captions, lens = _inputs()
    _, _, opt_state, _ = jax_step(trainable, frozen, opt_state,
                                  jax.random.PRNGKey(0), jnp.asarray(imgs),
                                  jnp.asarray(captions), jnp.asarray(lens))
    blob = pickle.dumps(jax.tree_util.tree_map(np.asarray, opt_state))
    import io

    inert = _CheckpointUnpickler(io.BytesIO(blob)).load()
    _, decoder, optimizer, _ = _port_setup(enc_tree, dec_tree, args)
    state = adam_state_from_jax(inert, decoder)
    assert len(state) == len(list(decoder.parameters()))
    optimizer.state.update(state)
    count, mu, nu = _jax_adam(opt_state)
    back = adam_state_to_jax(optimizer, decoder)
    assert int(back["count"]) == int(count) == 1
    for got, want in ((back["mu"], mu), (back["nu"], nu)):
        _assert_trees_close(got, _drop_empty(
            jax.tree_util.tree_map(np.asarray, want)))
    again = adam_state_from_jax(back, decoder)
    for p in decoder.parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again[p][key], state[p][key])


def test_eval_step_matches_jax():
    enc_tree = {"resnet": small_resnet_tree()}
    dec_tree = np_decoder_tree(V, A, H, E, D)
    imgs, captions, lens = _inputs(b=5, t=8, lengths=[7, 5, 2, 1, 0])
    want_loss, want_preds = jax_ta.make_eval_step()(
        _jax(enc_tree), _jax(dec_tree), jnp.asarray(imgs),
        jnp.asarray(captions), jnp.asarray(lens))
    step = make_eval_step(encoder_from_jax(enc_tree),
                          decoder_from_jax(dec_tree))
    loss, preds = step(torch.from_numpy(imgs), torch.from_numpy(captions),
                       torch.from_numpy(lens))
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), want_preds)
