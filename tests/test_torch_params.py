"""The weight bridge (icd_tpu_torch/params.py): JAX numpy trees <-> modules.

Round trips must be exact, and the modules' parameter names must follow
the JAX tree.
"""

import jax
import numpy as np
import pytest

from icd_tpu.models.attention import (AttentionDecoderParams,
                                      init_attention_decoder)
from icd_tpu.models.resnet import init_resnet
from icd_tpu_torch.params import (decoder_from_jax, decoder_to_jax,
                                  encoder_from_jax, encoder_to_jax)


def _random_bn(tree, rng):
    """Replace identity BN leaves with random values (var > 0)."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return {"scale": rng.standard_normal(c).astype(np.float32),
                    "bias": rng.standard_normal(c).astype(np.float32),
                    "mean": rng.standard_normal(c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_bn(v, rng) for v in tree]
    return np.asarray(tree)


def small_resnet_tree(depths=(1, 1, 1, 1), widths=(4, 8, 8, 16), seed=0):
    tree = init_resnet(jax.random.PRNGKey(seed), depths, widths)
    return _random_bn(tree, np.random.default_rng(seed))


def small_decoder_tree(vocab=19, att=32, dec=48, emb=8, enc=64, seed=0):
    class Cfg(AttentionDecoderParams):
        pass

    Cfg.attention_dim, Cfg.decoder_dim, Cfg.embed_size = att, dec, emb
    Cfg.vocab = list(range(vocab))
    return jax.tree_util.tree_map(np.asarray, init_attention_decoder(
        jax.random.PRNGKey(seed), Cfg(), encoder_dim=enc))


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_decoder_round_trip_exact():
    tree = small_decoder_tree()
    _assert_trees_equal(decoder_to_jax(decoder_from_jax(tree)), tree)


@pytest.mark.parametrize("depths", [(1, 1, 1, 1), (2, 1, 2, 1)])
def test_resnet_round_trip_exact(depths):
    tree = {"resnet": small_resnet_tree(depths)}
    _assert_trees_equal(encoder_to_jax(encoder_from_jax(tree)), tree)


def test_parameter_names_follow_jax_tree():
    dec = decoder_from_jax(small_decoder_tree())
    names = set(dict(dec.named_parameters()))
    assert {"attention.enc_att.weight", "attention.dec_att.bias",
            "attention.full_att.weight", "lstm.weight_ih", "lstm.bias_hh",
            "h_lin.weight", "c_lin.bias", "f_beta.weight", "fc.bias",
            "embedding.weight"} <= names
    enc = encoder_from_jax({"resnet": small_resnet_tree()})
    state = set(enc.state_dict())
    assert {"resnet.stem.conv", "resnet.stem.bn.scale", "resnet.stem.bn.mean",
            "resnet.layers.0.0.conv1", "resnet.layers.1.0.downsample.conv",
            "resnet.layers.3.0.bn3.var"} <= state


def test_layouts():
    """Linear (in, out) -> (out, in); LSTM (in, 4H) -> (4H, in); conv
    HWIO -> OIHW."""
    tree = small_decoder_tree()
    dec = decoder_from_jax(tree)
    np.testing.assert_array_equal(dec.f_beta.weight.detach().numpy(),
                                  tree["f_beta"]["w"].T)
    np.testing.assert_array_equal(dec.lstm.weight_hh.detach().numpy(),
                                  tree["lstm"]["wh"].T)
    rtree = small_resnet_tree()
    enc = encoder_from_jax({"resnet": rtree})
    np.testing.assert_array_equal(
        enc.resnet.stem.conv.detach().numpy(),
        rtree["stem"]["conv"].transpose(3, 2, 0, 1))
