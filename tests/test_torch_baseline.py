"""The baseline family's serving path (icd_tpu_torch models/baseline.py,
models/encoder.py's baseline head, decoding/greedy.py, the baseline
captioners of decoding/serve.py, params.py's baseline trees) vs icd_tpu's,
f32 on the CPU unless a test says otherwise.

Sizes: a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16) (64 channels out),
64x64 images, E = 16, H = 32, V = 97. Inputs come from numpy seeds.

A random decoder never emits ``<end>``, so the decoders here are
steered (``steer_end``): one LSTM unit counts steps at a rate that
depends on its input, and only that unit feeds the ``<end>`` logit, so
captions end after several different numbers of steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icd_tpu_torch.decoding.greedy as greedy
from icd_tpu.decoding import greedy as jax_greedy
from icd_tpu.decoding import serve as jax_serve
from icd_tpu.models import baseline as jax_baseline
from icd_tpu.models.lstm import lstm_scan as jax_lstm_scan
from icd_tpu.models.resnet_int8 import calibrate_act_maxes
from icd_tpu_torch.decoding.serve import (make_captioner,
                                          make_int8_captioner,
                                          make_int8_repeat_captioner,
                                          make_repeat_captioner)
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           baseline_decoder_forward,
                                           init_baseline_decoder,
                                           load_pretrained_embeddings)
from icd_tpu_torch.models.encoder import _embed, init_embed
from icd_tpu_torch.models.lstm import lstm_scan
from icd_tpu_torch.models.resnet import global_avg_pool
from icd_tpu_torch.params import (decoder_from_jax, decoder_to_jax,
                                  encoder_from_jax, encoder_to_jax,
                                  qdecoder_from_jax, qdecoder_to_jax)
from test_torch_params import small_resnet_tree
from test_torch_quant import _assert_trees_equal

V, E, H, ENC = 97, 16, 32, 64
START, END = V - 3, V - 2


def np_baseline_tree(vocab=V, emb=E, hidden=H, seed=0):
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


def steer_end(dec, end=END, rate=0.15, spread=0.15, threshold=20.0, unit=0):
    """Steer a numpy baseline tree in place: LSTM unit ``unit`` counts
    steps (i, f, o gates open, c from 0, g = tanh(atanh(rate) + spread *
    x . w)) and is the only input of the <end> logit, 40 * h - threshold."""
    hd = dec["lstm"]["wh"].shape[0]
    i, f, g, o = (gate * hd + unit for gate in range(4))
    lstm = dec["lstm"]
    lstm["wi"][:, [i, f, o]] = 0.0
    lstm["wh"][:, [i, f, g, o]] = 0.0
    lstm["bi"][[i, f, o]] = 10.0
    lstm["bh"][[i, f, g, o]] = 0.0
    lstm["wi"][:, g] *= spread
    lstm["bi"][g] = np.arctanh(rate)
    lin = dec["linear"]
    lin["w"][:, end] = 0.0
    lin["w"][unit, end] = 40.0
    lin["b"][end] = -threshold
    return dec


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _feats(b=6, seed=0):
    return np.random.default_rng(seed).standard_normal((b, E)).astype(
        np.float32)


def _encoder_tree(seed=0):
    rng = np.random.default_rng(seed + 10)
    return {"resnet": small_resnet_tree(seed=seed),
            "embed": {"w": rng.uniform(-0.125, 0.125, (ENC, E)).astype(
                          np.float32),
                      "b": rng.uniform(-0.125, 0.125, E).astype(
                          np.float32)}}


def _imgs(b=4, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (b, 64, 64, 3),
                                                dtype=np.uint8)


def _lengths(tokens, max_len):
    return [row.index(END) + 1 if END in row else max_len
            for row in np.asarray(tokens).tolist()]


@pytest.fixture
def count_steps(monkeypatch):
    """Counts the float loop's LSTM steps (step 0 included)."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    real = greedy.lstm_cell
    monkeypatch.setattr(greedy, "lstm_cell", counting)
    return calls


def test_lstm_scan_matches_jax():
    """Outputs and final state within atol 2e-6: the same f32 products
    and gates, summed in another order (sigmoid and tanh ulps as in
    tests/test_torch_qlinear.py)."""
    lstm = np_baseline_tree()["lstm"]
    xs = np.random.default_rng(1).standard_normal((3, 7, E)).astype(
        np.float32)
    ref_outs, (ref_h, ref_c) = jax_lstm_scan(_jax(lstm), jnp.asarray(xs))
    cell = decoder_from_jax(np_baseline_tree()).lstm
    outs, (h, c) = lstm_scan(cell, torch.from_numpy(xs))
    for a, b in ((outs, ref_outs), (h, ref_h), (c, ref_c)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=2e-6)


def test_baseline_decoder_forward_matches_jax():
    """Teacher-forced logits within atol 5e-6 (logits of magnitude ~1,
    the LSTM's atol 2e-6 carried through one more product)."""
    tree = np_baseline_tree()
    feats = _feats(3)
    caps = np.random.default_rng(3).integers(0, V, (3, 9)).astype(np.int32)
    ref = jax_baseline.baseline_decoder_forward(
        _jax(tree), jnp.asarray(feats), jnp.asarray(caps))
    with torch.no_grad():
        out = baseline_decoder_forward(decoder_from_jax(tree),
                                       torch.from_numpy(feats),
                                       torch.from_numpy(caps).long())
    assert out.shape == (3, 9, V)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-6)


@pytest.mark.parametrize("ends", [True, False],
                         ids=["ends_early", "runs_to_max_len"])
def test_greedy_decode_baseline_matches_jax(count_steps, ends):
    """Tokens equal; the loop leaves as soon as every caption has ended,
    and runs max_len steps when <end> is unreachable."""
    tree, max_len = steer_end(np_baseline_tree()), 20
    if not ends:
        tree["linear"]["b"][END] = -1e9
    feats = _feats()
    ref = jax_greedy.greedy_decode_baseline(_jax(tree), jnp.asarray(feats),
                                            START, END, max_len=max_len)
    toks = greedy.greedy_decode_baseline(decoder_from_jax(tree),
                                         torch.from_numpy(feats), START,
                                         END, max_len=max_len)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))
    lens = _lengths(toks, max_len)
    assert len(count_steps) == max(lens)
    if ends:
        assert max(lens) < max_len and len(set(lens)) > 1
    else:
        assert lens == [max_len] * len(lens) and not (toks == END).any()


def test_quantize_baseline_decoder_matches_jax():
    """The int8 tree equals JAX's bit for bit, both ways through
    params.py (columns padded to 8 here, sliced off there)."""
    tree = np_baseline_tree()
    ref = jax.tree_util.tree_map(
        np.asarray, jax_greedy.quantize_baseline_decoder(_jax(tree)))
    q = greedy.quantize_baseline_decoder(decoder_from_jax(tree))
    assert q["linear"]["wq"].shape == (H, 104)  # V = 97 padded to 104
    _assert_trees_equal(qdecoder_to_jax(q), ref)
    _assert_trees_equal(qdecoder_to_jax(qdecoder_from_jax(ref)), ref)


def test_greedy_decode_baseline_int8_matches_jax():
    """On JAX's own int8 tree: tokens equal (qmatmul is bit-equal, h and
    c within the sigmoid and tanh ulps, tests/test_torch_qlinear.py)."""
    tree, max_len = steer_end(np_baseline_tree(seed=1)), 20
    jq = jax_greedy.quantize_baseline_decoder(_jax(tree))
    feats = _feats(seed=4)
    ref = jax_greedy.greedy_decode_baseline_int8(
        jq, jnp.asarray(feats), START, END, max_len=max_len)
    toks = greedy.greedy_decode_baseline_int8(
        qdecoder_from_jax(jax.tree_util.tree_map(np.asarray, jq)),
        torch.from_numpy(feats), START, END, max_len=max_len)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))
    lens = _lengths(toks, max_len)
    assert max(lens) < max_len and len(set(lens)) > 1


def _serving_problem():
    return _encoder_tree(), steer_end(np_baseline_tree(seed=2)), _imgs()


def _assert_ended_tokens_equal(out, ref, max_len):
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert max(_lengths(out, max_len)) < max_len


@pytest.mark.parametrize("int8", [False, True])
def test_captioner_matches_jax(int8):
    """make_captioner against JAX's, float backbone and the dynamic int8
    one: tokens equal. (JAX jits its captioner, so features sit an ulp
    away here and there; tokens agree.)"""
    enc, dec, imgs = _serving_problem()
    ref = jax_serve.make_captioner(enc, dec, START, END, max_len=15,
                                   compute_dtype=jnp.float32, int8=int8)(
        jnp.asarray(imgs))
    out = make_captioner(encoder_from_jax(enc), decoder_from_jax(dec),
                         START, END, max_len=15, compute_dtype=torch.float32,
                         int8=int8, device="cpu")(imgs)
    _assert_ended_tokens_equal(out, ref, 15)


@pytest.mark.parametrize("int8_decoder", [False, True])
def test_int8_captioner_matches_jax(int8_decoder):
    """make_int8_captioner with the float and the W8A8 decoder, the same
    act_maxes on both sides: tokens equal. Calibrating on the same
    images gives act_maxes within rtol 1e-5 (float convolutions in
    another order)."""
    enc, dec, imgs = _serving_problem()
    act_maxes = calibrate_act_maxes(enc["resnet"], imgs, jnp.float32)
    ref = jax_serve.make_int8_captioner(
        enc, dec, START, END, max_len=15, compute_dtype=jnp.float32,
        act_maxes=act_maxes, int8_decoder=int8_decoder)(jnp.asarray(imgs))
    captioner = make_int8_captioner(
        encoder_from_jax(enc), decoder_from_jax(dec), START, END,
        max_len=15, compute_dtype=torch.float32, act_maxes=act_maxes,
        int8_decoder=int8_decoder, device="cpu")
    _assert_ended_tokens_equal(captioner(imgs), ref, 15)
    assert captioner.act_maxes is act_maxes
    assert (captioner.qdec is not None) == int8_decoder
    calibrated = make_int8_captioner(
        encoder_from_jax(enc), decoder_from_jax(dec), START, END,
        compute_dtype=torch.float32, calib_imgs=imgs, device="cpu")
    np.testing.assert_allclose(calibrated.act_maxes, act_maxes, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_repeat_captioners_match_jax(int8):
    """The repeat captioners' int32 checksums equal JAX's; a salt near
    255 makes the uint8 perturbation wrap."""
    enc, dec, imgs = _serving_problem()
    salt, repeats = 253, 4
    if int8:
        act_maxes = calibrate_act_maxes(enc["resnet"], imgs, jnp.float32)
        kw = dict(act_maxes=act_maxes, int8_decoder=True)
        ref_cap = jax_serve.make_int8_repeat_captioner
        cap = make_int8_repeat_captioner
    else:
        kw, ref_cap, cap = {}, jax_serve.make_repeat_captioner, \
            make_repeat_captioner
    ref = ref_cap(enc, dec, START, END, max_len=15,
                  compute_dtype=jnp.float32, repeats=repeats, **kw)(
        jnp.asarray(imgs), jnp.int32(salt))
    port = cap(encoder_from_jax(enc), decoder_from_jax(dec), START, END,
               max_len=15, compute_dtype=torch.float32, repeats=repeats,
               device="cpu", **kw)
    out = port(imgs, salt)
    assert out.dtype == torch.int32 and int(out) == int(ref)
    one = sum(int(port.captioner(imgs + np.uint8(i)).sum())
              for i in (253, 254, 255, 0))
    assert int(out) == one


def test_encoder_round_trip_exact():
    tree = _encoder_tree()
    enc = encoder_from_jax(tree)
    _assert_trees_equal(encoder_to_jax(enc), tree)
    back = encoder_from_jax(encoder_to_jax(enc))
    for (name, a), (_, b) in zip(enc.state_dict().items(),
                                 back.state_dict().items()):
        assert torch.equal(a, b), name
    assert set(enc.state_dict()) >= {"embed.weight", "embed.bias",
                                     "resnet.stem.conv"}
    np.testing.assert_array_equal(enc.embed.weight.detach().numpy(),
                                  tree["embed"]["w"].T)


def test_decoder_round_trip_exact():
    tree = np_baseline_tree()
    dec = decoder_from_jax(tree)
    _assert_trees_equal(decoder_to_jax(dec), tree)
    gen = torch.Generator().manual_seed(0)
    p = BaselineDecoderParams()
    p.vocab_size, p.embed_size, p.hidden_size = V, E, H
    module = init_baseline_decoder(gen, p, device="cpu")
    back = decoder_from_jax(decoder_to_jax(module))
    for (name, a), (_, b) in zip(module.state_dict().items(),
                                 back.state_dict().items()):
        assert torch.equal(a, b), name
    assert set(module.state_dict()) == {
        "embedding.weight", "lstm.weight_ih", "lstm.weight_hh",
        "lstm.bias_ih", "lstm.bias_hh", "linear.weight", "linear.bias"}


def test_init_matches_torch_defaults():
    """init_baseline_decoder and init_encoder's head draw torch's default
    ranges (baseline.py:27-41, encoder.py:30-36)."""
    gen = torch.Generator().manual_seed(0)
    p = BaselineDecoderParams()
    p.vocab_size = 300
    dec = init_baseline_decoder(gen, p, device="cpu")
    bound = 1 / np.sqrt(512)
    for t in (dec.lstm.weight_ih, dec.linear.weight, dec.linear.bias):
        assert t.abs().max() <= bound and t.abs().max() > 0.9 * bound
    assert abs(dec.embedding.weight.std().item() - 1.0) < 0.01
    table = np.ones((300, 512))
    swapped = load_pretrained_embeddings(dec, table)
    assert swapped.embedding.weight.dtype == torch.float32
    assert torch.equal(swapped.embedding.weight, torch.ones(300, 512))
    assert not torch.equal(dec.embedding.weight, swapped.embedding.weight)
    head = init_embed(gen, 16, device="cpu")
    bound = 1 / np.sqrt(2048)
    for t in (head.weight, head.bias):
        assert t.abs().max() <= bound and t.abs().max() > 0.9 * bound


def test_bf16_pool_and_embed_round_as_jax():
    """In bf16: the pool sums in f32 and rounds once, the embed product
    rounds before its bias is added, as JAX's ``jnp.mean`` and
    ``x @ w + b`` do: equal to JAX bit for bit. A product with the bias
    added before its one rounding is not."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((4, 7, 7, 64)).astype(np.float32)
    w = rng.uniform(-0.125, 0.125, (64, 48)).astype(np.float32)
    b = rng.uniform(-1, 1, 48).astype(np.float32)
    bf = jnp.bfloat16
    ref_pool = jnp.mean(jnp.asarray(feats, bf), axis=(1, 2))
    pooled = global_avg_pool(torch.from_numpy(feats).to(torch.bfloat16))
    assert pooled.dtype == torch.bfloat16
    np.testing.assert_array_equal(pooled.float().numpy(),
                                  np.asarray(ref_pool, np.float32))
    ref = ref_pool @ jnp.asarray(w, bf) + jnp.asarray(b, bf)
    lin = torch.nn.Linear(64, 48).to(torch.bfloat16)
    lin.weight.data = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
    lin.bias.data = torch.from_numpy(b).to(torch.bfloat16)
    with torch.no_grad():
        out = _embed(lin, pooled)
        fused = torch.nn.functional.linear(pooled, lin.weight, lin.bias)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert not torch.equal(fused, out)
    f32 = global_avg_pool(torch.from_numpy(feats))
    np.testing.assert_allclose(
        f32.numpy(), np.asarray(jnp.mean(jnp.asarray(feats), axis=(1, 2))),
        rtol=0, atol=1e-6)
