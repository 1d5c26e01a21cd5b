"""Training of the baseline captioner, and --amp / --int8_encoder training
of both model families (icd_tpu_torch training/baseline.py,
training/common.py, models/encoder.py's train mode and head mask,
models/resnet.py's bf16 train-mode BN, params.py's Adam bridge) against
icd_tpu's, on the CPU.

Tolerances, and why:
- f32 steps: losses rtol 1e-5 (XLA and ATen sum in other orders);
  Adam's moments within 1e-4 of each tensor's largest value; updated
  parameters within 1e-2 * lr a step (a gradient element near Adam's eps
  turns its last-bit difference into up to 1e-2 of a step,
  tests/test_torch_train.py); BN statistics rtol 1e-5, atol 1e-5;
- the pad mask: the port pads to the batch's longest caption, icd_tpu's
  baseline loader to a multiple of 8; losses rtol 1e-6 and gradients
  within 1e-6 of their largest value (the extra pads only add zeros);
- the eval step: per-sample losses rtol 1e-5, argmax predictions equal;
- bf16 (--amp): one bf16 rounding is at most 2^-8 relative, so one
  train-mode BN output is within 2^-8 of |y| (plus 1e-6) of JAX's, the
  pooled map within one rounding; through a whole step the bf16
  roundings of two libraries differ in place, so the loss is held to
  1e-2 relative and BN statistics (f32, computed from bf16 activations)
  to 2e-2 of their largest value; a first Adam step moves an element by
  lr * sign(g) unless |g| is near eps, so two steps differ by more than
  lr / 100 only where the gradients' signs differ, which bf16 noise
  flips only for elements near zero: at most 10 % of the parameters
  (XLA's CPU backend keeps chains of bf16 elementwise operations in f32
  and rounds once, the port rounds after each; the attention model's
  scores, softmax and gates give 4.4 % at these sizes, the baseline
  0.4 %);
- int8 trunk: given the same int8 tree, the port's trunk equals eager
  JAX bit for bit (tests/test_torch_quant.py); the jitted JAX step
  contracts the dequant affine into an FMA, one ulp away, so an f32
  int8 step's loss is within rtol 1e-5, an amp one within the bf16
  limit above.

Sizes: a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16) (64 channels out)
with random BN statistics, 64x64 images, E = 16, H = 12, V = 40,
batch 4, captions of 7 tokens (padded to 8 for icd_tpu).
"""

import io
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icd_tpu.training.attention as jax_ta
import icd_tpu.training.baseline as jax_tb
from icd_tpu.data.pipeline import DataLoader as JaxDataLoader
from icd_tpu.models.baseline import (
    baseline_decoder_forward as jax_baseline_forward)
from icd_tpu.models.encoder import encoder_forward as jax_encoder_forward
from icd_tpu.models.encoder import (
    encoder_forward_int8 as jax_encoder_forward_int8)
from icd_tpu.models.encoder import trainable_mask as jax_trainable_mask
from icd_tpu.models.resnet import batch_norm as jax_batch_norm
from icd_tpu.models.resnet import global_avg_pool as jax_global_avg_pool
from icd_tpu.models.resnet import resnet_forward as jax_resnet_forward
from icd_tpu.models.resnet_int8 import calibrate_act_maxes as jax_calibrate
from icd_tpu.models.resnet_int8 import quantize_resnet as jax_quantize
from icd_tpu.models.resnet_int8 import (
    resnet_int8_forward as jax_resnet_int8_forward)
from icd_tpu.ops.image import normalize_imagenet as jax_normalize
from icd_tpu.training.common import cast_floating as jax_cast_floating
from icd_tpu.training.common import cross_entropy as jax_cross_entropy
from icd_tpu.training.common import merge, partition
from icd_tpu_torch.checkpoint import _CheckpointUnpickler
from icd_tpu_torch.data.pipeline import DataLoader
from icd_tpu_torch.models.encoder import encoder_forward_int8, trainable_mask
from icd_tpu_torch.models.resnet import (BatchNorm, batch_norm_train,
                                         global_avg_pool, merge_bn_stats,
                                         resnet_forward)
from icd_tpu_torch.models.resnet_int8 import resnet_int8_forward
from icd_tpu_torch.ops.image import normalize_imagenet
from icd_tpu_torch.params import (_put, adam_state_from_jax,
                                  adam_state_to_jax, decoder_from_jax,
                                  decoder_leaves, decoder_to_jax,
                                  encoder_from_jax, encoder_to_jax,
                                  qresnet_from_jax, qresnet_to_jax,
                                  resnet_from_jax)
from icd_tpu_torch.training import attention as ta
from icd_tpu_torch.training import baseline as tb
from icd_tpu_torch.training.common import (cast_floating, make_adam,
                                           pad_cross_entropy,
                                           prepare_int8_encoder)
from helpers import make_train_args
from test_torch_params import small_resnet_tree
from test_torch_qlinear import np_decoder_tree

V, E, H, D = 40, 16, 12, 64
PAD, START, END = 0, 1, 2
A = 10  # the attention family's attention width
BF16 = torch.bfloat16


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got, want, rtol=0.0, atol=0.0, scaled=False):
    """Leaf by leaf; ``scaled``: atol relative to each leaf's max."""
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w, np.float32)
        tol = atol * max(np.abs(w).max(), 1e-30) if scaled else atol
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=tol)


def baseline_tree(vocab=V, emb=E, hidden=H, seed=0):
    """A baseline-decoder tree (init_baseline_decoder's structure and
    ranges) drawn with numpy."""
    rng = np.random.default_rng(seed)
    b = 1 / np.sqrt(hidden)

    def uniform(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {"embedding": rng.standard_normal((vocab, emb)).astype(
                np.float32),
            "lstm": {"wi": uniform(emb, 4 * hidden),
                     "wh": uniform(hidden, 4 * hidden),
                     "bi": uniform(4 * hidden), "bh": uniform(4 * hidden)},
            "linear": {"w": uniform(hidden, vocab), "b": uniform(vocab)}}


def encoder_tree(seed=0):
    rng = np.random.default_rng(100 + seed)
    bound = 1 / np.sqrt(D)
    return {"resnet": small_resnet_tree(seed=seed),
            "embed": {"w": rng.uniform(-bound, bound, (D, E)).astype(
                          np.float32),
                      "b": rng.uniform(-bound, bound, E).astype(
                          np.float32)}}


def captions(b=4, t=7, seed=0):
    """(b, t) captions, <start> words <end> then <pad>, the first row the
    longest, and their lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, t + 1, b)
    lengths[0] = t
    caps = np.full((b, t), PAD, np.int32)
    for i, n in enumerate(lengths):
        caps[i, 0] = START
        caps[i, 1:n - 1] = rng.integers(4, V, n - 2)
        caps[i, n - 1] = END
    return caps, lengths.astype(np.int32)


def pad8(caps):
    """icd_tpu's baseline collate: captions padded to a multiple of 8."""
    t = -(-caps.shape[1] // 8) * 8
    return np.pad(caps, ((0, 0), (0, t - caps.shape[1])),
                  constant_values=PAD)


def images(b=4, seed=0):
    return np.random.default_rng(50 + seed).integers(
        0, 256, (b, 64, 64, 3), dtype=np.uint8)


# ---------------------------------------------------------------------------
# The pad-masked CE, the head's mask, the decoder's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_to_8", [False, True])
def test_pad_cross_entropy_matches_jax(pad_to_8):
    """The port's CE on pad-to-longest targets against icd_tpu's
    ``cross_entropy(..., ignore_index=pad)``, on the same targets or on
    them padded to 8 (as icd_tpu's baseline loader pads): the same loss
    and the same gradients at the shared positions; the extra positions
    take no gradient."""
    rng = np.random.default_rng(4)
    caps, _ = captions(seed=4)
    logits = rng.standard_normal((4, 7, V)).astype(np.float32)
    jcaps, jlogits = caps, logits
    if pad_to_8:
        jcaps = pad8(caps)
        jlogits = np.concatenate(
            [logits, rng.standard_normal((4, 1, V)).astype(np.float32)], 1)
    want, want_grad = jax.value_and_grad(
        lambda x: jax_cross_entropy(x, jnp.asarray(jcaps), ignore_index=PAD))(
        jnp.asarray(jlogits))
    x = torch.from_numpy(logits).requires_grad_()
    got = pad_cross_entropy(x, torch.from_numpy(caps), PAD)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want_grad = np.asarray(want_grad)
    assert not want_grad[:, 7:].any()
    np.testing.assert_allclose(x.grad.numpy(), want_grad[:, :7], rtol=0,
                               atol=1e-6 * np.abs(want_grad).max())


def test_pad_cross_entropy_of_all_pads_is_zero():
    """max(count, 1): a batch with every target <pad> gives 0, not NaN."""
    logits = torch.randn(2, 3, V)
    targets = torch.full((2, 3), PAD)
    want = jax_cross_entropy(jnp.asarray(logits.numpy()),
                             jnp.zeros((2, 3), jnp.int32), ignore_index=PAD)
    got = pad_cross_entropy(logits, targets, PAD)
    assert got.item() == float(want) == 0.0


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("fine_tune", [False, True])
def test_trainable_mask_with_head_matches_jax(head, fine_tune):
    tree = encoder_tree()
    want = jax_trainable_mask(tree, fine_tune=fine_tune, head=head)
    encoder = encoder_from_jax(tree)
    mask = trainable_mask(encoder, fine_tune=fine_tune, head=head)
    assert mask["embed.weight"] == mask["embed.bias"] == head
    for name, _ in encoder.named_parameters():
        node = want
        for part in name.replace("weight", "w").replace("bias", "b").split(
                ".") if name.startswith("embed.") else name.split("."):
            node = node[int(part) if isinstance(node, list) else part]
        assert mask[name] == node, name


def _decoder_loss_grads(dec_tree, feats, caps, dtype):
    """The baseline CE's gradients over every decoder leaf: JAX's
    (jax.grad through ``cast_floating``) and the port's (autograd
    through ``cast_floating``), as numpy trees."""
    jdt = None if dtype is None else jnp.bfloat16

    def jax_loss(dec):
        scores = jax_baseline_forward(jax_cast_floating(dec, jdt),
                                      jax_cast_floating(feats, jdt), caps)
        return jax_cross_entropy(scores.astype(jnp.float32), caps,
                                 ignore_index=PAD)

    want = jax.grad(jax_loss)(_jax(dec_tree))
    decoder = decoder_from_jax(dec_tree)
    loss = tb.decoder_loss(decoder, torch.from_numpy(np.asarray(feats)),
                           torch.from_numpy(np.asarray(caps)), PAD, dtype)
    loss.backward()
    got = {}
    for path, p, transposed in decoder_leaves(decoder):
        g = p.grad.numpy()
        assert p.grad.dtype == torch.float32
        _put(got, path, g.T.copy() if transposed else g)
    return got, _np(want)


@pytest.mark.parametrize("dtype", [None, BF16])
def test_baseline_decoder_backward_matches_jax(dtype):
    """The teacher-forced forward's backward (the Python loop of
    ``lstm_scan`` under autograd): f32 gradients within 1e-5 of each
    leaf's largest value; bf16 (the AMP cast, gradients reaching the
    f32 masters) within 3e-2, a few bf16 roundings of the sums."""
    feats = np.random.default_rng(5).standard_normal((4, E)).astype(
        np.float32)
    caps, _ = captions(seed=5)
    got, want = _decoder_loss_grads(baseline_tree(), feats, caps, dtype)
    _assert_trees_close(got, want, atol=1e-5 if dtype is None else 3e-2,
                        scaled=True)


# ---------------------------------------------------------------------------
# bf16 train-mode BN and the pooled map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 5, 8), (3, 1, 1, 6)])
def test_bf16_train_batch_norm_matches_jax(shape):
    """icd_tpu's train-mode BN under --amp: scale and bias at bf16 (the
    cast copy), the running statistics f32; batch statistics and the
    blend at f32, one rounding of y."""
    rng = np.random.default_rng(1)
    c = shape[-1]
    bn_tree = {"scale": rng.standard_normal(c).astype(np.float32),
               "bias": rng.standard_normal(c).astype(np.float32),
               "mean": rng.standard_normal(c).astype(np.float32),
               "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 1).astype(
        np.float32)).to(BF16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jbn = dict(_jax(bn_tree), scale=jnp.asarray(bn_tree["scale"]).astype(
        jnp.bfloat16), bias=jnp.asarray(bn_tree["bias"]).astype(jnp.bfloat16))
    want_y, want_bn = jax_batch_norm(jx, jbn, train=True)
    bn = BatchNorm(c)
    with torch.no_grad():
        for key in bn_tree:
            getattr(bn, key).copy_(torch.from_numpy(bn_tree[key]))
    with torch.no_grad():
        y, stats = batch_norm_train(x, bn, compute_dtype=BF16)
    assert y.dtype == BF16 and want_y.dtype == jnp.bfloat16
    want_y = np.asarray(want_y.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=2 ** -8,
                               atol=1e-6)
    assert (y.float().numpy() == want_y).mean() >= 0.9
    for key in ("mean", "var"):
        assert stats[key].dtype == torch.float32
        assert want_bn[key].dtype == jnp.float32
        np.testing.assert_allclose(stats[key].numpy(), want_bn[key],
                                   rtol=1e-5, atol=1e-5)


def test_bf16_global_avg_pool_matches_jax():
    """jnp.mean of a bf16 map: sum and divide in f32, one rounding."""
    x = torch.randn(3, 7, 7, 64, generator=torch.Generator().manual_seed(2))
    x = (x * 4 + 1).to(BF16)
    want = jax_global_avg_pool(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    got = global_avg_pool(x)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8)
    assert (got.float().numpy() == want).mean() >= 0.95


def test_bf16_train_mode_resnet_matches_jax():
    """The frozen trunk in train mode under --amp: bf16 features (the
    roundings of two libraries compound over the blocks: relative L2
    error within 2e-2) and f32 running statistics close to JAX's at bf16
    scale (2e-2 of each tensor's largest value)."""
    tree = small_resnet_tree()
    x = np.random.default_rng(2).standard_normal((3, 64, 64, 3)).astype(
        np.float32)
    want_feats, want_tree = jax_resnet_forward(
        _jax(tree), jnp.asarray(x), train=True, compute_dtype=jnp.bfloat16)
    net = resnet_from_jax(tree)
    with torch.no_grad():
        feats, stats = resnet_forward(net, torch.from_numpy(x), train=True,
                                      compute_dtype=BF16)
    assert feats.dtype == BF16
    want = np.asarray(want_feats.astype(jnp.float32))
    err = np.linalg.norm(feats.float().numpy() - want) / np.linalg.norm(want)
    assert err <= 2e-2, err
    for bn, new in stats.items():
        assert new["mean"].dtype == new["var"].dtype == torch.float32
    merge_bn_stats(stats)
    got = encoder_to_jax(type("E", (), {"resnet": net})())["resnet"]
    _assert_trees_close(got, _np(want_tree), atol=2e-2, scaled=True)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def _jax_setup(enc_tree, dec_tree, args, family="baseline",
               compute_dtype=None, qresnet=None):
    """icd_tpu's train state and jitted step, built as its train() does."""
    params = {"encoder": _jax(enc_tree), "decoder": _jax(dec_tree)}
    head = args.fine_tune_encoder if family == "baseline" else False
    mask = {"encoder": jax_trainable_mask(params["encoder"], fine_tune=False,
                                          head=head),
            "decoder": jax_tb._decoder_trainable_mask(
                params["decoder"], args.fine_tune_embedding)}
    trainable, frozen = partition(params, mask)
    tx = jax_tb.make_optimizer_for(trainable, args)
    if family == "baseline":
        raw = jax_tb.make_train_step(PAD, mask, tx, compute_dtype, qresnet)
    else:
        raw = jax_ta.make_train_step(mask, tx, args.alpha_c,
                                     args.decoder_dropout, compute_dtype,
                                     qresnet)
    return trainable, frozen, tx.init(trainable), jax.jit(raw)


def _port_setup(enc_tree, dec_tree, args, family="baseline",
                compute_dtype=None, qresnet=None):
    encoder, decoder = encoder_from_jax(enc_tree), decoder_from_jax(dec_tree)
    if family == "baseline":
        optimizer = make_adam(args, encoder, decoder, None,
                              head=args.fine_tune_encoder)
        step = tb.make_train_step(encoder, decoder, optimizer, PAD,
                                  args.grad_clip, compute_dtype, qresnet)
    else:
        optimizer = make_adam(args, encoder, decoder, None)
        step = ta.make_train_step(encoder, decoder, optimizer, args.alpha_c,
                                  args.decoder_dropout, args.grad_clip,
                                  compute_dtype, qresnet)
    return encoder, decoder, optimizer, step


def _jax_adams(opt_state):
    """{group: (count, mu, nu)} of icd_tpu's multi_transform state."""
    out = {}
    for group in ("encoder", "decoder"):
        adam = opt_state.inner_states[group].inner_state[1][0]
        out[group] = (adam.count, _np(adam.mu), _np(adam.nu))
    return out


def _drop_empty(tree):
    """The arrays of an optax moment tree (None and MaskedNode dropped)."""
    if isinstance(tree, dict):
        out = {k: _drop_empty(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None} or None
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        kept = [_drop_empty(v) for v in tree]
        return None if all(v is None for v in kept) else kept
    return tree if hasattr(tree, "shape") else None


def _run_steps(family, steps, args, compute_dtype=None, qtree=None,
               fine_tune_encoder=False):
    """The same steps through icd_tpu's jitted step and the port's:
    (port's encoder, decoder, optimizer, losses; JAX's merged numpy
    params, opt_state, losses)."""
    if family == "baseline":
        enc_tree, dec_tree = encoder_tree(), baseline_tree()
    else:
        enc_tree = {"resnet": small_resnet_tree()}
        dec_tree = np_decoder_tree(V, A, H, E, D)
    jq = None if qtree is None else _jax(qtree)
    pq = None if qtree is None else qresnet_from_jax(qtree)
    jdt = None if compute_dtype is None else jnp.bfloat16
    trainable, frozen, opt_state, jax_step = _jax_setup(
        enc_tree, dec_tree, args, family, jdt, jq)
    encoder, decoder, optimizer, step = _port_setup(
        enc_tree, dec_tree, args, family, compute_dtype, pq)
    got, want = [], []
    for i in range(steps):
        imgs = images(seed=10 + i)
        caps, _ = captions(seed=10 + i)
        if family == "baseline":
            trainable, frozen, opt_state, loss = jax_step(
                trainable, frozen, opt_state, jnp.asarray(imgs),
                jnp.asarray(pad8(caps)))
            got.append(step(torch.from_numpy(imgs),
                            torch.from_numpy(caps)).item())
        else:
            lens = np.full(4, caps.shape[1] - 1, np.int32)
            trainable, frozen, opt_state, loss = jax_step(
                trainable, frozen, opt_state, jax.random.PRNGKey(0),
                jnp.asarray(imgs), jnp.asarray(caps), jnp.asarray(lens))
            got.append(step(torch.from_numpy(imgs), torch.from_numpy(caps),
                            torch.from_numpy(lens)).item())
        want.append(float(loss))
    return dict(encoder=encoder, decoder=decoder, optimizer=optimizer,
                losses=got, jax=_np(merge(trainable, frozen)),
                opt_state=opt_state, jax_losses=want, enc_tree=enc_tree,
                dec_tree=dec_tree)


@pytest.mark.parametrize("fine_tune_encoder", [False, True])
@pytest.mark.parametrize("steps", [1, 2])
def test_baseline_train_steps_match_jax(steps, fine_tune_encoder):
    """f32, grad_clip 0.02 (it bites), the embedding frozen as by
    default, the head trained with --fine_tune_encoder. icd_tpu's step
    sees the captions padded to 8, the port's padded to the longest.
    Loss, decoder, head, Adam count/mu/nu of both groups, new BN
    statistics."""
    args = make_train_args(grad_clip=0.02, decoder_lr=1e-3, encoder_lr=1e-3,
                           fine_tune_encoder=fine_tune_encoder)
    run = _run_steps("baseline", steps, args)
    np.testing.assert_allclose(run["losses"], run["jax_losses"], rtol=1e-5)
    encoder, decoder = run["encoder"], run["decoder"]
    lr, full = args.decoder_lr, run["jax"]
    assert decoder.embedding.weight.grad is None
    assert any(bool((p.grad.abs() == args.grad_clip).any())
               for p in decoder.parameters() if p.grad is not None)
    _assert_trees_close(decoder_to_jax(decoder), full["decoder"],
                        atol=1e-2 * lr * steps)
    np.testing.assert_array_equal(decoder.embedding.weight.numpy(),
                                  run["dec_tree"]["embedding"])
    got_enc = encoder_to_jax(encoder)
    _assert_trees_close(got_enc["embed"], full["encoder"]["embed"],
                        atol=1e-2 * lr * steps)
    moved = not np.array_equal(got_enc["embed"]["w"],
                               run["enc_tree"]["embed"]["w"])
    assert moved == fine_tune_encoder
    _assert_trees_close(got_enc["resnet"], full["encoder"]["resnet"],
                        rtol=1e-5, atol=1e-5)

    state = adam_state_to_jax(run["optimizer"], decoder, encoder)
    adams = _jax_adams(run["opt_state"])
    assert int(state["count"]) == int(adams["decoder"][0]) == steps
    for i, key in ((1, "mu"), (2, "nu")):
        want = {"decoder": _drop_empty(adams["decoder"][i]["decoder"])}
        if fine_tune_encoder:
            want["encoder"] = _drop_empty(adams["encoder"][i]["encoder"])
        assert set(state[key]) == set(want)
        _assert_trees_close(state[key], want, atol=1e-4, scaled=True)


def _frozen_equal(encoder, enc_tree, decoder=None, dec_tree=None):
    """The frozen weights came back bit-identical; only BN statistics may
    differ."""
    got = encoder_to_jax(encoder)["resnet"]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(enc_tree["resnet"])[0])
    for path, value in flat_g:
        if path[-1].key not in ("mean", "var"):
            np.testing.assert_array_equal(value, flat_w[path])
    if decoder is not None:
        np.testing.assert_array_equal(decoder.embedding.weight.numpy(),
                                      dec_tree["embedding"])


def _masters_f32(encoder, decoder, optimizer):
    for module in (encoder, decoder):
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            assert t.dtype == torch.float32, name
    for state in optimizer.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
            == torch.float32


def _step_share_beyond(got_tree, want_tree, lr):
    g = jax.tree_util.tree_leaves(got_tree)
    w = jax.tree_util.tree_leaves(want_tree)
    beyond = sum(int((np.abs(a - b) > lr / 100).sum()) for a, b in zip(g, w))
    return beyond / sum(a.size for a in g)


@pytest.mark.parametrize("family", ["baseline", "attention"])
def test_amp_step_matches_jax(family):
    """One --amp step (bf16 compute over f32 masters) of each family:
    the loss within 1e-2; every master weight, buffer and Adam moment
    f32; the frozen weights bit-identical to the input; BN statistics
    f32, moved, and close to JAX's at bf16 scale; at most 10 % of the
    updated parameters more than lr / 100 from JAX's."""
    args = make_train_args(model=family, decoder_dropout=0.0, decoder_lr=1e-3,
                           grad_clip=5.0)
    run = _run_steps(family, 1, args, compute_dtype=BF16)
    got, want = run["losses"][0], run["jax_losses"][0]
    assert abs(got - want) / abs(want) <= 1e-2, (got, want)
    encoder, decoder = run["encoder"], run["decoder"]
    _masters_f32(encoder, decoder, run["optimizer"])
    _frozen_equal(encoder, run["enc_tree"], decoder, run["dec_tree"])
    got_enc, full = encoder_to_jax(encoder), run["jax"]
    before = run["enc_tree"]["resnet"]["stem"]["bn"]["mean"]
    assert not np.array_equal(got_enc["resnet"]["stem"]["bn"]["mean"], before)
    _assert_trees_close(got_enc["resnet"], full["encoder"]["resnet"],
                        atol=2e-2, scaled=True)
    share = _step_share_beyond(decoder_to_jax(decoder), full["decoder"],
                               args.decoder_lr)
    assert share <= 0.1, share


def test_cast_floating_casts_inside_autograd():
    """The AMP cast: inside the call the parameters are bf16 copies; the
    gradients reach the f32 masters as f32; the module is unchanged."""
    decoder = decoder_from_jax(baseline_tree())
    before = {n: p.detach().clone() for n, p in decoder.named_parameters()}
    seen = []

    def forward(dec, x):
        seen.append({n: p.dtype for n, p in dec.named_parameters()})
        return (x @ dec.linear.weight.t()).float().sum()

    cast_floating(forward, decoder, BF16,
                  torch.ones(2, H, dtype=BF16)).backward()
    assert set(seen[0].values()) == {BF16}
    grad = decoder.linear.weight.grad
    assert grad.dtype == torch.float32 and bool((grad == 2.0).all())
    for name, p in decoder.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p.detach(), before[name]), name
    assert cast_floating(forward, decoder, None,
                         torch.ones(2, H)).dtype == torch.float32
    assert set(seen[-1].values()) == {torch.float32}


# ---------------------------------------------------------------------------
# --int8_encoder
# ---------------------------------------------------------------------------

class _MemoryItems:
    """A train split of ``n`` seeded items (64x64 uint8, a caption)."""

    def __init__(self, n):
        rng = np.random.default_rng(9)
        self.imgs = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
        self.caps = [captions(1, 7, seed=i)[0][0] for i in range(n)]

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], self.caps[i]


def _loaders(n):
    items = _MemoryItems(n)
    return (DataLoader(items, batch_size=2, shuffle=True, pad_idx=PAD),
            JaxDataLoader(items, batch_size=2, shuffle=True, pad_idx=PAD,
                          drop_last=False))


@pytest.mark.parametrize("warmup,dtype", [(True, None), (True, BF16),
                                          (False, None)])
def test_prepare_int8_encoder_matches_jax(warmup, dtype):
    """16 batches of f32 train-mode BN warm-up (none when resuming), then
    calibration on the last batch at the compute dtype and quantization,
    against icd_tpu's ``_prepare_int8_encoder`` on a loader of the same
    items: warmed statistics rtol 1e-5 (f32 sums in other orders over 16
    steps), int8 weights equal, each site's act_max (127 / inv_in) and
    folded affine within 1e-4 in f32 and at bf16 scale (2e-2) under
    --amp; then both loaders give the same next epoch, the warm-up having
    drawn one shuffle each."""
    port_loader, jax_loader = _loaders(36)  # 18 batches
    enc_tree = encoder_tree()
    jdt = None if dtype is None else jnp.bfloat16
    want_q, want_enc = jax_tb._prepare_int8_encoder(
        _jax(enc_tree), jax_loader, jax_encoder_forward, jdt, warmup=warmup)
    encoder = encoder_from_jax(enc_tree)
    got_q = qresnet_to_jax(prepare_int8_encoder(encoder.resnet, port_loader,
                                                dtype, warmup=warmup))
    _assert_trees_close(encoder_to_jax(encoder)["resnet"],
                        _np(want_enc["resnet"]), rtol=1e-5, atol=1e-5)
    if not warmup:
        _assert_trees_close(encoder_to_jax(encoder), enc_tree)
    tol = 1e-4 if dtype is None else 2e-2
    flat_g = jax.tree_util.tree_flatten_with_path(got_q)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(_np(want_q))[0])
    assert len(flat_g) == len(flat_w)
    for path, value in flat_g:
        want = flat_w[path]
        if path[-1].key == "wq":
            np.testing.assert_array_equal(value, want)
        else:
            np.testing.assert_allclose(value, want, rtol=tol,
                                       atol=tol * np.abs(want).max())
    for p, j in zip(iter(port_loader), iter(jax_loader)):
        np.testing.assert_array_equal(p["imgs"], j["imgs"])


def test_prepare_int8_encoder_without_batches_raises():
    port_loader, jax_loader = _loaders(0)
    with pytest.raises(RuntimeError) as want:
        jax_tb._prepare_int8_encoder(_jax(encoder_tree()), jax_loader,
                                     jax_encoder_forward, None)
    with pytest.raises(RuntimeError) as got:
        prepare_int8_encoder(encoder_from_jax(encoder_tree()).resnet,
                             port_loader, None)
    assert str(got.value) == str(want.value)


def _qtree(enc_tree):
    """icd_tpu's int8 tree of the small trunk, calibrated in f32."""
    resnet = _jax(enc_tree["resnet"])
    return _np(jax_quantize(resnet, jax_calibrate(
        resnet, jnp.asarray(images(seed=3)), jnp.float32)))


def test_f32_int8_trunk_matches_jax():
    """``resnet_int8_forward(out_dtype=float32)`` (--int8_encoder without
    --amp) equals eager JAX bit for bit given the same tree; the head's
    features through ``encoder_forward_int8`` in f32 agree to rtol 1e-5
    (XLA and ATen pool and multiply in other orders)."""
    enc_tree = encoder_tree()
    qtree = _qtree(enc_tree)
    imgs = images(seed=4)
    x = jax_normalize(jnp.asarray(imgs))
    want = np.asarray(jax_resnet_int8_forward(_jax(qtree), x,
                                              out_dtype=jnp.float32))
    got = resnet_int8_forward(qresnet_from_jax(qtree),
                              normalize_imagenet(torch.from_numpy(imgs)),
                              out_dtype=torch.float32)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    want = jax_encoder_forward_int8(_jax(enc_tree), _jax(qtree),
                                    jnp.asarray(imgs), jnp.float32)
    with torch.no_grad():
        got = encoder_forward_int8(encoder_from_jax(enc_tree),
                                   qresnet_from_jax(qtree),
                                   torch.from_numpy(imgs), torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [None, BF16])
@pytest.mark.parametrize("family", ["baseline", "attention"])
def test_int8_step_matches_jax(family, dtype):
    """One --int8_encoder step of each family, f32 and --amp, from the
    same int8 tree: the loss within the jitted JAX step's one-ulp FMA
    distance (rtol 1e-5) in f32 and within 1e-2 under --amp; BN
    statistics unchanged, and the whole trunk bit-identical."""
    args = make_train_args(model=family, decoder_dropout=0.0,
                           decoder_lr=1e-3)
    enc_tree = (encoder_tree() if family == "baseline"
                else {"resnet": small_resnet_tree()})
    run = _run_steps(family, 1, args, compute_dtype=dtype,
                     qtree=_qtree(enc_tree))
    got, want = run["losses"][0], run["jax_losses"][0]
    assert abs(got - want) / abs(want) <= (1e-5 if dtype is None else 1e-2)
    _assert_trees_close(encoder_to_jax(run["encoder"])["resnet"],
                        run["enc_tree"]["resnet"])
    _assert_trees_close(run["jax"]["encoder"]["resnet"],
                        run["enc_tree"]["resnet"])
    _masters_f32(run["encoder"], run["decoder"], run["optimizer"])


# ---------------------------------------------------------------------------
# The eval step and the Adam bridge
# ---------------------------------------------------------------------------

def test_baseline_eval_step_matches_jax():
    """icd_tpu's eval step on captions padded to 8 against the port's on
    captions padded to the longest: per-sample losses (each sample's
    mean over its own length, no ignore_index) and the argmax
    predictions at the shared positions."""
    enc_tree, dec_tree = encoder_tree(), baseline_tree()
    imgs = images(b=5, seed=6)
    caps, lengths = captions(b=5, seed=6)
    want_loss, want_preds = jax_tb.make_eval_step()(
        _jax(enc_tree), _jax(dec_tree), jnp.asarray(imgs),
        jnp.asarray(pad8(caps)), jnp.asarray(lengths.astype(np.float32)))
    step = tb.make_eval_step(encoder_from_jax(enc_tree),
                             decoder_from_jax(dec_tree))
    loss, preds = step(torch.from_numpy(imgs), torch.from_numpy(caps),
                       torch.from_numpy(lengths))
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(),
                                  np.asarray(want_preds)[:, :caps.shape[1]])


def test_adam_state_from_icd_tpu_baseline_checkpoint():
    """An icd_tpu baseline optax state whose encoder head trains (two
    groups, each with MaskedNodes at the other's leaves), pickled and read
    back through the port's unpickler, becomes Adam state equal to the
    JAX moments for the decoder and the head; the port's own form
    round-trips."""
    args = make_train_args(fine_tune_encoder=True, fine_tune_embedding=True)
    enc_tree, dec_tree = encoder_tree(), baseline_tree()
    trainable, frozen, opt_state, jax_step = _jax_setup(enc_tree, dec_tree,
                                                        args)
    caps, _ = captions()
    _, _, opt_state, _ = jax_step(trainable, frozen, opt_state,
                                  jnp.asarray(images()),
                                  jnp.asarray(pad8(caps)))
    blob = pickle.dumps(_np(opt_state))
    inert = _CheckpointUnpickler(io.BytesIO(blob)).load()
    encoder, decoder, optimizer, _ = _port_setup(enc_tree, dec_tree, args)
    state = adam_state_from_jax(inert, decoder, encoder)
    assert len(state) == len(list(decoder.parameters())) + 2
    optimizer.state.update(state)
    back = adam_state_to_jax(optimizer, decoder, encoder)
    adams = _jax_adams(opt_state)
    assert int(back["count"]) == 1
    for i, key in ((1, "mu"), (2, "nu")):
        want = {"decoder": _drop_empty(adams["decoder"][i]["decoder"]),
                "encoder": _drop_empty(adams["encoder"][i]["encoder"])}
        _assert_trees_close(back[key], want)
    again = adam_state_from_jax(back, decoder, encoder)
    assert set(again) == set(state)
    for p in state:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again[p][key], state[p][key])


def test_make_adam_loads_state_only_for_trained_parameters():
    """Resuming with the head frozen from a checkpoint whose head trained:
    Adam takes the decoder's moments and none for the frozen head."""
    args = make_train_args(fine_tune_encoder=True)
    enc_tree, dec_tree = encoder_tree(), baseline_tree()
    trainable, frozen, opt_state, jax_step = _jax_setup(enc_tree, dec_tree,
                                                        args)
    caps, _ = captions()
    _, _, opt_state, _ = jax_step(trainable, frozen, opt_state,
                                  jnp.asarray(images()),
                                  jnp.asarray(pad8(caps)))
    inert = _CheckpointUnpickler(io.BytesIO(pickle.dumps(
        _np(opt_state)))).load()
    encoder, decoder = encoder_from_jax(enc_tree), decoder_from_jax(dec_tree)
    optimizer = make_adam(make_train_args(), encoder, decoder, inert)
    trained = [p for p in decoder.parameters() if p.requires_grad]
    assert set(map(id, optimizer.state)) == set(map(id, trained))
    assert not encoder.embed.weight.requires_grad
