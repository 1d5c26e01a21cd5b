"""icd_tpu_torch beam search vs icd_tpu's (f32, CPU).

The same numpy decoder tree and grids go through
``icd_tpu.decoding.beam.beam_search_batched`` (vmapped while loop) and
the port's written-out (B, k) loop. seq, seq_len and found must be
equal; alphas agree to atol 5e-6 (the two frameworks sum in different
orders). Problem size follows tests/test_fused_beam.py: b=4, k=5, P=16,
V=40, 7 steps.

A random decoder finishes every image with [start, end] at step 1, so
the decoders here are steered (``steer_end``): one LSTM unit counts the
steps at an image-dependent rate, and the <end> logit follows it. That
gives captions of several lengths, images that retire all their beams
early beside images that run to ``max_steps``, and images that never
finish.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icd_tpu.decoding.beam import beam_search_batched as jax_beam
from icd_tpu.models.attention import (AttentionDecoderParams,
                                      init_attention_decoder)
from icd_tpu_torch.decoding.beam import _top_k, beam_search_batched
from icd_tpu_torch.params import decoder_from_jax

B, K, P, V, D, E = 4, 5, 16, 40, 64, 16
START, END = V - 3, V - 2
MAX_STEPS = 7


def steer_end(dec, end, rate, spread, threshold, unit=0):
    """Steer a numpy decoder tree in place: LSTM unit ``unit`` becomes a
    step counter (i, f, o gates open, c starting at 0, g = tanh(atanh(
    rate) + spread * ctx . w)), and only that unit feeds the <end> logit,
    40 * h_unit - threshold. Other logits are scaled up 10x."""
    e = dec["embedding"].shape[1]
    hd = dec["lstm"]["wh"].shape[0]
    i, f, g, o = (gate * hd + unit for gate in range(4))
    lstm = dec["lstm"]
    lstm["wi"][:, [i, f, o]] = 0.0
    lstm["wh"][:, [i, f, g, o]] = 0.0
    lstm["bi"][[i, f, o]] = 10.0
    lstm["bh"][[i, f, g, o]] = 0.0
    lstm["wi"][:e, g] = 0.0
    lstm["wi"][e:, g] *= spread
    lstm["bi"][g] = np.arctanh(rate)
    dec["c_lin"]["w"][:, unit] = 0.0
    dec["c_lin"]["b"][unit] = 0.0
    dec["fc"]["w"] *= 10.0
    dec["fc"]["w"][:, end] = 0.0
    dec["fc"]["w"][unit, end] = 40.0
    dec["fc"]["b"][end] = -threshold
    return dec


def _decoder(rate=0.1, spread=1.0, threshold=20.0, seed=0):
    class Cfg(AttentionDecoderParams):
        pass

    Cfg.attention_dim, Cfg.decoder_dim, Cfg.embed_size = 24, 32, E
    Cfg.vocab = list(range(V))
    dec = jax.tree_util.tree_map(
        lambda x: np.array(x),
        init_attention_decoder(jax.random.PRNGKey(seed), Cfg(),
                               encoder_dim=D))
    return steer_end(dec, END, rate, spread, threshold)


def _grids(b=B):
    return np.random.default_rng(0).standard_normal((b, P, D)).astype(
        np.float32)


def _assert_same(dec, grids, max_steps=MAX_STEPS):
    ref = jax_beam(dec, jnp.asarray(grids), K, START, END,
                   max_steps=max_steps)
    out = beam_search_batched(decoder_from_jax(dec), torch.from_numpy(grids),
                              K, START, END, max_steps=max_steps)
    np.testing.assert_array_equal(out["seq"].numpy(), np.asarray(ref["seq"]))
    np.testing.assert_array_equal(out["seq_len"].numpy(),
                                  np.asarray(ref["seq_len"]))
    np.testing.assert_array_equal(out["found"].numpy(),
                                  np.asarray(ref["found"]))
    np.testing.assert_allclose(out["alphas"].numpy(),
                               np.asarray(ref["alphas"]), rtol=0, atol=5e-6)
    return out


def _steps_alone(dec, grids):
    """Decode steps each image runs when it is decoded by itself."""
    tdec = decoder_from_jax(dec)
    return [beam_search_batched(tdec, torch.from_numpy(grids[i:i + 1]), K,
                                START, END, max_steps=MAX_STEPS)["steps"]
            for i in range(grids.shape[0])]


def test_beam_matches_jax_varied_lengths():
    out = _assert_same(_decoder(0.2, 0.5), _grids())
    assert out["found"].all()
    assert len(set(out["seq_len"].tolist())) >= 3


def test_beam_early_finish_beside_max_steps():
    """Images that retire all beams early stay frozen while the rest of
    the batch runs on to max_steps (beam.py:123-124 under vmap)."""
    dec = _decoder(0.1, 1.0)
    grids = _grids()
    steps = _steps_alone(dec, grids)
    assert min(steps) < MAX_STEPS and max(steps) == MAX_STEPS, steps
    out = _assert_same(dec, grids)
    assert out["steps"] == MAX_STEPS


def test_beam_found_and_not_found_in_one_batch():
    out = _assert_same(_decoder(0.2, 1.0), _grids())
    assert out["found"].any() and not out["found"].all()


def test_beam_no_finish_protocol():
    """<end> unreachable: every image gets [start, end], seq_len 2
    (beam.py:242-246), and alphas keep best_last_alpha's all-ones row."""
    dec = _decoder(0.2, 0.5)
    dec["fc"]["b"][END] = -1e9
    out = _assert_same(dec, _grids())
    assert not out["found"].any()
    np.testing.assert_array_equal(out["seq_len"].numpy(), np.full((B,), 2))
    np.testing.assert_array_equal(out["alphas"][:, 1].numpy(),
                                  np.ones((B, P), np.float32))


def test_beam_exact_ties():
    """Duplicated fc columns give bit-identical logits for twin words;
    top-k must then break ties by ascending index like lax.top_k."""
    dec = _decoder(0.2, 0.5)
    twins = np.arange(17)
    dec["fc"]["w"][:, twins + 20] = dec["fc"]["w"][:, twins]
    dec["fc"]["b"][twins + 20] = dec["fc"]["b"][twins]
    grids = _grids()
    _assert_same(dec, grids)
    # The premise: twin logits are bit-identical in both frameworks.
    tdec = decoder_from_jax(dec)
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 32)).astype(np.float32))
    logits = torch.nn.functional.linear(h, tdec.fc.weight, tdec.fc.bias)
    jlogits = np.asarray(jnp.asarray(h.numpy()) @ dec["fc"]["w"]
                         + dec["fc"]["b"])
    for lg in (logits.detach().numpy(), jlogits):
        np.testing.assert_array_equal(lg[:, twins], lg[:, twins + 20])


@pytest.mark.parametrize("k", [1, 3, 5])
def test_top_k_tie_order_matches_lax(k):
    rng = np.random.default_rng(k)
    flat = rng.integers(-3, 1, size=(6, 4 * V)).astype(np.float32)
    flat[:, :7] = -1e9  # masked rows tie too
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(flat), k)
    v, i = _top_k(torch.from_numpy(flat), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
