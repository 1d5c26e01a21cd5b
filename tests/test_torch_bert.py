"""The port's BERT (icd_tpu_torch models/bert_tokenize.py, models/bert.py,
models/bert_load.py and params.py's BERT bridge) against
``transformers`` (the tokenizer, ``save_pretrained`` directories) and
icd_tpu's ``models/bert_jax.py``, f32 on the CPU.

Tolerances, and why:
- the tokenizer: equal pieces and ids (string work, no rounding);
- hidden states and aligned embeddings: atol 2e-5, as
  tests/test_bert_jax.py holds JAX against transformers (the port and
  XLA sum the products and the LayerNorms in other orders); padded
  positions are not compared;
- W8A8: the quantized weights are equal (the same division, rounding
  and clamp); the outputs within 1e-4 of JAX's W8A8 forward (a row's
  activation that rounds to the other int8 neighbour moves a product
  by one quantization step, 1e-4 of this model's outputs at most), and
  within 5 % of the f32 forward's scale, as tests/test_bert_jax.py
  bounds JAX's;
- padded keys: probabilities exactly 0 (exp(-1e9) underflows), valid
  rows within 1e-6 (products over more rows may sum in another order).

Sizes: vocab 43, hidden 24, 3 layers, 4 heads, FFN 48, 64 positions.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icd_tpu.models.bert_jax import (bert_aligned_forward as jax_aligned,
                                     bert_encoder_forward as jax_forward,
                                     bert_from_torch, quantize_bert_params)
from icd_tpu_torch.models.bert import (BERT_BASE, QLinear, TorchBert,
                                       bert_aligned_forward,
                                       bert_encoder_forward, init_bert,
                                       quantize_bert)
from icd_tpu_torch.models.bert_load import (bert_from_state_dict,
                                            load_bert_dir, read_safetensors)
from icd_tpu_torch.models.bert_tokenize import BertTokenizer
from icd_tpu_torch.params import bert_from_jax, bert_to_jax
from conftest import CAPTIONS

WORDPIECES = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "<", ">", "start", "end",
    "pad", "unk", "a", "man", "rid", "##ing", "horse", "on", "the",
    "beach", ".", ",", "dog", "run", "##s", "cafe", "caf", "##e", "1",
    "##2", "##3", "un", "##aff", "##able", "'", "s", "-", "x" * 101,
    "zz", "中", "οδοσ", "!", "?", "##z",
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("bertvocab") / "vocab.txt"
    path.write_text("\n".join(WORDPIECES))
    return str(path)


@pytest.fixture(scope="module")
def torch_bert():
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    config = BertConfig(
        vocab_size=43, hidden_size=24, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=48,
        max_position_embeddings=64)
    return BertModel(config).eval()


TEXTS = (["[CLS] " + c for _, c in CAPTIONS["train"] + CAPTIONS["val"]] + [
    "[CLS] <start> a man riding a horse <end> <pad> <pad>",
    "Café CAFÉ cafés naïve", "dog's run-runs! 123 1,2.3 ?!",
    "unaffable UNAFFABLE [UNK] zzz [MASK]x[SEP]y", "x" * 101, "x" * 100,
    "中文 a\x00b\tc　d​", "ΟΔΟΣ", "[cls] [Cls] <unk>",
    "  leading and\ntrailing  "])


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_transformers(vocab_file, text):
    from transformers import BertTokenizer as HFBertTokenizer

    want = HFBertTokenizer(vocab_file, do_lower_case=True)
    got = BertTokenizer(vocab_file)
    pieces = got.tokenize(text)
    assert pieces == want.tokenize(text)
    assert got.convert_tokens_to_ids(pieces) == want.convert_tokens_to_ids(
        pieces)


def _jax_params(torch_bert):
    params, config = bert_from_torch(torch_bert)
    return jax.tree_util.tree_map(jnp.asarray, params), config


def _padded_inputs(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 43, (3, 9)).astype(np.int32)
    attn = np.ones((3, 9), np.int32)
    attn[0, 6:] = 0
    attn[1, 4:] = 0
    ids[attn == 0] = 0
    seg = np.full((3, 9), -1, np.int32)
    seg[0, :6] = [0, 1, 1, 2, 4, 4]  # word 3 takes no piece: a zero row
    seg[1, :4] = [0, 0, 1, 2]
    seg[2, :8] = [0, 1, 2, 3, 4, 5, 5, 5]  # the last piece taken by none
    return ids, attn, seg


def test_encoder_forward_matches_jax_with_padding(torch_bert):
    params, config = _jax_params(torch_bert)
    ids, attn, _ = _padded_inputs()
    want = np.asarray(jax_forward(params, jnp.asarray(ids), jnp.asarray(attn),
                                  config["num_heads"], config["ln_eps"]))
    bert = bert_from_jax(jax.tree_util.tree_map(np.asarray, params), config)
    got = bert_encoder_forward(bert, torch.from_numpy(ids),
                               torch.from_numpy(attn)).numpy()
    valid = attn.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5)


@pytest.mark.parametrize("n_words", [6, 9])
def test_aligned_forward_matches_jax(torch_bert, n_words):
    params, config = _jax_params(torch_bert)
    ids, attn, seg = _padded_inputs()
    want = np.asarray(jax_aligned(params, jnp.asarray(ids), jnp.asarray(attn),
                                  jnp.asarray(seg), n_words,
                                  config["num_heads"], config["ln_eps"]))
    bert = bert_from_jax(jax.tree_util.tree_map(np.asarray, params), config)
    got = bert_aligned_forward(bert, torch.from_numpy(ids),
                               torch.from_numpy(attn), torch.from_numpy(seg),
                               n_words).numpy()
    assert got.shape == (3, n_words, 24)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert not got[0, 3].any() and not got[:, 6:].any()


@pytest.mark.parametrize("int8", [False, True])
def test_torch_bert_aligned(torch_bert, int8):
    """``TorchBert`` (the counterpart of ``JaxBert``) on the CPU: the
    aligned tensor from numpy inputs equals the plain function's on the
    same (quantized, with ``int8``) weights."""
    bert = bert_from_state_dict(*load_state(torch_bert))
    ids, attn, seg = _padded_inputs(2)
    tb = TorchBert(bert, "cpu", int8=int8)
    assert isinstance(tb.bert.layers[0].q, QLinear) == int8
    aligned = tb.aligned(ids, attn, seg, 7)
    want = bert_aligned_forward(quantize_bert(bert) if int8 else bert,
                                *(torch.from_numpy(a) for a in (ids, attn,
                                                                seg)), 7)
    assert isinstance(aligned, torch.Tensor) and aligned.shape == (3, 7, 24)
    torch.testing.assert_close(aligned, want, rtol=0, atol=0)


def test_padded_keys_change_no_valid_row(torch_bert):
    """The -1e9 bias makes a padded key's probability an exact 0, so a
    batch padded further (as XLA's buckets pad it) gives the same valid
    rows; eager PyTorch therefore needs no buckets."""
    bert = bert_from_state_dict(*load_state(torch_bert))
    ids, attn, _ = _padded_inputs(3)
    more = np.pad(ids, ((0, 0), (0, 7)))
    more_attn = np.pad(attn, ((0, 0), (0, 7)))
    scores = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 4, 9, 16)).astype(np.float32)) + (
        1.0 - torch.from_numpy(more_attn).float())[:, None, None, :] * -1e9
    probs = torch.softmax(scores, dim=-1)
    assert not probs[..., 9:].any()
    short = bert_encoder_forward(bert, torch.from_numpy(ids),
                                 torch.from_numpy(attn)).numpy()
    long = bert_encoder_forward(bert, torch.from_numpy(more),
                                torch.from_numpy(more_attn)).numpy()
    valid = attn.astype(bool)
    np.testing.assert_allclose(long[:, :9][valid], short[valid], atol=1e-6)


def test_w8a8_matches_jax(torch_bert):
    params, config = _jax_params(torch_bert)
    qparams = quantize_bert_params(jax.tree_util.tree_map(np.asarray, params))
    bert = bert_from_jax(jax.tree_util.tree_map(np.asarray, params), config)
    qbert = quantize_bert(bert)
    assert all(isinstance(getattr(layer, name), QLinear)
               for layer in qbert.layers for name in ("q", "ffn_out"))
    got_tree, got_config = bert_to_jax(qbert)
    assert got_config == config
    g_leaves, g_def = jax.tree_util.tree_flatten(got_tree)
    w_leaves, w_def = jax.tree_util.tree_flatten(qparams)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)

    ids, attn, _ = _padded_inputs(4)
    valid = attn.astype(bool)
    want = np.asarray(jax_forward(
        jax.tree_util.tree_map(jnp.asarray, qparams), jnp.asarray(ids),
        jnp.asarray(attn), config["num_heads"], config["ln_eps"]))
    got = bert_encoder_forward(qbert, torch.from_numpy(ids),
                               torch.from_numpy(attn)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)
    f32 = bert_encoder_forward(bert, torch.from_numpy(ids),
                               torch.from_numpy(attn)).numpy()
    assert np.abs(got - f32)[valid].max() < 0.05 * np.abs(f32).max()
    # The int8 tree comes back through the bridge as the same module.
    again = bert_from_jax(got_tree, got_config)
    np.testing.assert_array_equal(
        bert_encoder_forward(again, torch.from_numpy(ids),
                             torch.from_numpy(attn)).numpy(), got)


def load_state(torch_bert):
    """(state dict of numpy arrays, config dict) of a transformers
    ``BertModel``, as ``load_bert_dir`` gives them."""
    state = {k: v.numpy() for k, v in torch_bert.state_dict().items()}
    return state, torch_bert.config.to_dict()


def _bridge(bert):
    return jax.tree_util.tree_leaves(bert_to_jax(bert)[0])


@pytest.mark.parametrize("safe_serialization", [True, False])
@pytest.mark.parametrize("prefix", [False, True])
def test_load_bert_dir_matches_bert_from_torch(torch_bert, tmp_path,
                                               safe_serialization, prefix):
    """A ``save_pretrained`` directory (model.safetensors or
    pytorch_model.bin; a BertModel's keys, or a headed model's with
    ``bert.`` and a pooler) reads to ``bert_jax.bert_from_torch``'s
    arrays."""
    model = torch_bert
    if prefix:
        from transformers import BertForPreTraining

        model = BertForPreTraining(torch_bert.config).eval()
        model.bert.load_state_dict(torch_bert.state_dict())
    model.save_pretrained(str(tmp_path), safe_serialization=safe_serialization)
    names = set(os.listdir(tmp_path))
    assert ("model.safetensors" in names) == safe_serialization
    state, config = load_bert_dir(str(tmp_path))
    assert not any(k.startswith(("bert.", "pooler.", "cls.")) for k in state)
    assert config["num_attention_heads"] == 4
    want, want_config = bert_from_torch(torch_bert)
    got, got_config = bert_to_jax(bert_from_state_dict(state, config))
    assert got_config == want_config
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_load_bert_dir_reads_old_layer_norm_names(torch_bert, tmp_path):
    """The original bert-base-uncased pytorch_model.bin names its
    LayerNorms' weight and bias ``gamma`` and ``beta``, under ``bert.``."""
    import json

    state = {"bert." + k.replace("LayerNorm.weight", "LayerNorm.gamma")
             .replace("LayerNorm.bias", "LayerNorm.beta"): v
             for k, v in torch_bert.state_dict().items()}
    torch.save(state, str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps(
        torch_bert.config.to_dict()))
    got, _ = bert_to_jax(bert_from_state_dict(*load_bert_dir(str(tmp_path))))
    want, _ = bert_from_torch(torch_bert)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_read_safetensors_half_types(tmp_path, dtype):
    from safetensors.torch import save_file

    t = torch.randn(3, 5).to(getattr(torch, dtype))
    save_file({"x": t, "y": torch.arange(4.0)}, str(tmp_path / "m.safetensors"))
    got = read_safetensors(str(tmp_path / "m.safetensors"))
    np.testing.assert_array_equal(got["x"], t.float().numpy())
    np.testing.assert_array_equal(got["y"], np.arange(4.0, dtype=np.float32))


def test_bert_bridge_round_trip(torch_bert):
    params, config = bert_from_torch(torch_bert)
    bert = bert_from_jax(params, config)
    back, back_config = bert_to_jax(bert)
    assert back_config == config
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_bridge(bert_from_jax(back, back_config)), _bridge(bert)):
        np.testing.assert_array_equal(g, w)


def test_init_bert_geometry():
    """``init_bert`` at a cut bert-base geometry: transformers' init
    (N(0, 0.02), the [PAD] row 0, biases 0, LayerNorm weights 1)."""
    config = dict(BERT_BASE, num_hidden_layers=1, vocab_size=100)
    bert = init_bert(torch.Generator().manual_seed(0), config, "cpu")
    assert bert.word.weight.shape == (100, 768)
    assert bert.pos.weight.shape == (512, 768)
    assert bert.layers[0].ffn_in.weight.shape == (3072, 768)
    assert not bert.word.weight[0].any()
    assert abs(bert.layers[0].q.weight.std().item() - 0.02) < 1e-3
    assert not bert.layers[0].q.bias.any()
    assert bool((bert.layers[0].ln_out.weight == 1).all())
    assert not any(p.requires_grad for p in bert.parameters())


@pytest.mark.parametrize("change", ["none", "weights", "float"])
def test_shared_quantization_records_and_replays(torch_bert, change):
    """``testing.SharedQuantization`` (chip_smoke's bert_int8 holds the card
    to the CPU with it): recording changes nothing, the same forward
    replayed gives the same output bit for bit with equal int32 sums at
    every product; other int8 weights break the sums; a float change
    before the first product shows in ``input_err`` while the sums stay
    equal, since the recorded int8 rows are the ones summed."""
    from icd_tpu_torch.testing import SharedQuantization

    qbert = quantize_bert(bert_from_state_dict(*load_state(torch_bert)))
    ids, attn, _ = _padded_inputs(3)
    ids, attn = torch.from_numpy(ids), torch.from_numpy(attn)
    shared = SharedQuantization()
    with torch.no_grad():
        plain = bert_encoder_forward(qbert, ids, attn)
        with shared.applied():
            recorded = bert_encoder_forward(qbert, ids, attn)
        assert len(shared.records) == 6 * len(qbert.layers)
        torch.testing.assert_close(recorded, plain, rtol=0, atol=0)
        other = copy.deepcopy(qbert)
        if change == "weights":
            other.layers[1].k.wq.neg_()
        elif change == "float":
            other.ln_emb.bias.add_(1e-3)
        with shared.applied():
            replayed = bert_encoder_forward(other, ids, attn)
    assert shared.sums_equal == (change != "weights")
    if change == "none":
        assert shared.input_err == 0.0
        torch.testing.assert_close(replayed, plain, rtol=0, atol=0)
    elif change == "float":
        assert shared.input_err > 1e-5


def test_tf32_operands_round_like_tf32():
    """``testing.tf32_operands`` (bert_int8's TF32 control): ``to_tf32``
    keeps 10 mantissa bits, within half a TF32 unit (2^-11 relative),
    leaves TF32 values and other dtypes alone; within the context
    ``torch.matmul`` multiplies the rounded operands."""
    from icd_tpu_torch.testing import tf32_operands, to_tf32

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    r = to_tf32(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(to_tf32(r), r)
    assert torch.equal(to_tf32(x.double()), x.double())
    with tf32_operands():
        got = torch.matmul(x, y)
    torch.testing.assert_close(got, torch.matmul(r, to_tf32(y)), rtol=0,
                               atol=0)
    assert not torch.equal(got, torch.matmul(x, y))
