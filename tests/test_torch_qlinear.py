"""W8A8 decoder products (icd_tpu_torch ops/qlinear.py) vs icd_tpu's
(ops/qlinear.py), on the CPU.

- ``quantize_linear``, ``quantize_rows`` and ``qmatmul`` are bit-equal
  to JAX's: integers, one IEEE division per element, an int32 sum and
  the same two products; ``qmatmul`` at fewer than 17 rows, at depths and
  widths that are not multiples of 8 (padded for cuBLASLt and sliced
  back), and the padding of the weights holds zeros;
- ``qlstm_cell``'s gate sums are bit-equal, and h and c agree within
  atol 1e-6: XLA and ATen compute sigmoid and tanh with different
  polynomials (measured 2.4e-7 on c of magnitude up to 3.6, 1.2e-7 on
  h);
- the segments must cover every row of the input weight;
- ``quantize_attention_decoder``'s tree equals JAX's through
  ``qdecoder_to_jax`` and ``qdecoder_from_jax``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icd_tpu.decoding.greedy_attention import (
    quantize_attention_decoder as jax_quantize_decoder)
from icd_tpu.ops import qlinear as jq
from icd_tpu_torch.decoding.greedy_attention import (
    quantize_attention_decoder)
from icd_tpu_torch.ops import qlinear
from icd_tpu_torch.ops.quant import int_mm
from icd_tpu_torch.params import (decoder_from_jax, qdecoder_from_jax,
                                  qdecoder_to_jax)
from test_torch_quant import _assert_trees_equal


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def np_decoder_tree(vocab, att, dec, emb, enc, seed=0):
    """An attention-decoder tree (init_attention_decoder's structure and
    ranges) drawn with numpy."""
    rng = np.random.default_rng(seed)

    def uniform(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def linear(fan_in, fan_out):
        bound = 1 / np.sqrt(fan_in)
        return {"w": uniform(bound, fan_in, fan_out),
                "b": uniform(bound, fan_out)}

    hb = 1 / np.sqrt(dec)
    return {
        "attention": {"enc_att": linear(enc, att),
                      "dec_att": linear(dec, att),
                      "full_att": linear(att, 1)},
        "lstm": {"wi": uniform(hb, emb + enc, 4 * dec),
                 "wh": uniform(hb, dec, 4 * dec),
                 "bi": uniform(hb, 4 * dec), "bh": uniform(hb, 4 * dec)},
        "h_lin": linear(enc, dec), "c_lin": linear(enc, dec),
        "f_beta": linear(dec, enc),
        "fc": {"w": uniform(0.1, dec, vocab),
               "b": np.zeros(vocab, np.float32)},
        "embedding": uniform(0.1, vocab, emb)}


# (M, K, N): fewer rows than cuBLASLt takes, N a prime, K not a
# multiple of 8, and a batch of 40.
MM_SHAPES = [(5, 48, 97), (16, 36, 24), (40, 64, 40), (17, 20, 9)]


@pytest.mark.parametrize("shape", MM_SHAPES)
def test_qmatmul_bit_equal(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * k * n)
    x, w = _normal(rng, m, k), _normal(rng, k, n, scale=0.2)
    jwq, jws = jq.quantize_linear(jnp.asarray(w))
    wq, ws = qlinear.quantize_linear(torch.from_numpy(w))
    assert wq.shape == (k, -(-n // 8) * 8) and wq.stride() == (1, k)
    np.testing.assert_array_equal(wq[:, :n].numpy(), np.asarray(jwq))
    assert not wq[:, n:].any()
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    jxq, jxs = jq.quantize_rows(jnp.asarray(x))
    xq, xs = qlinear.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    ref = np.asarray(jq.qmatmul(jnp.asarray(x), jwq, jws))
    out = qlinear.qmatmul(torch.from_numpy(x), wq, ws)
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_int_mm_pads_and_slices():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 13), np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (13, 6), np.int8))
    out = int_mm(a, b)
    assert out.shape == (3, 6) and out.dtype == torch.int32
    assert torch.equal(out.long(), a.long() @ b.long())
    assert torch.equal(int_mm(a, b, 4), out[:, :4])


def _lstm_problem(seed=0, e=16, d=40, hd=24, b=5):
    rng = np.random.default_rng(seed)
    lstm = {"wi": _normal(rng, e + d, 4 * hd, scale=0.2),
            "wh": _normal(rng, hd, 4 * hd, scale=0.2),
            "bi": _normal(rng, 4 * hd, scale=0.1),
            "bh": _normal(rng, 4 * hd, scale=0.1)}
    emb, ctx = _normal(rng, b, e), _normal(rng, b, d, scale=10.0)
    h, c = _normal(rng, b, hd), _normal(rng, b, hd)
    return lstm, emb, ctx, h, c


def _torch_cell(lstm):
    cell = torch.nn.LSTMCell(*lstm["wi"].shape[:1], lstm["wh"].shape[0])
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(lstm["wi"].T))
        cell.weight_hh.copy_(torch.from_numpy(lstm["wh"].T))
        cell.bias_ih.copy_(torch.from_numpy(lstm["bi"]))
        cell.bias_hh.copy_(torch.from_numpy(lstm["bh"]))
    return cell


def test_qlstm_cell_matches_jax():
    lstm, emb, ctx, h, c = _lstm_problem()
    jqp = jq.quantize_lstm({k: jnp.asarray(v) for k, v in lstm.items()})
    qp = qlinear.quantize_lstm(_torch_cell(lstm))
    for key in ("wis", "whs", "b"):
        np.testing.assert_array_equal(qp[key].numpy(), np.asarray(jqp[key]))
    n = 4 * h.shape[1]
    np.testing.assert_array_equal(qp["wiq"][:, :n].numpy(),
                                  np.asarray(jqp["wiq"]))
    e = emb.shape[1]
    x = (emb, ctx, h)
    jx = [jnp.asarray(v) for v in x]
    tx = [torch.from_numpy(v) for v in x]
    jgates = (jq.qmatmul(jx[0], jqp["wiq"][:e], jqp["wis"])
              + jq.qmatmul(jx[1], jqp["wiq"][e:], jqp["wis"])
              + jq.qmatmul(jx[2], jqp["whq"], jqp["whs"]) + jqp["b"])
    gates = (qlinear.qmatmul(tx[0], qp["wiq"][:e], qp["wis"])
             + qlinear.qmatmul(tx[1], qp["wiq"][e:], qp["wis"])
             + qlinear.qmatmul(tx[2], qp["whq"], qp["whs"]) + qp["b"])
    np.testing.assert_array_equal(gates.numpy(), np.asarray(jgates))
    jh, jc = jq.qlstm_cell(jqp, (jx[0], jx[1]), jx[2], jnp.asarray(c))
    th, tc = qlinear.qlstm_cell(qp, (tx[0], tx[1]), tx[2],
                                torch.from_numpy(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def test_qlstm_cell_segments_must_cover_the_weight():
    lstm, emb, ctx, h, c = _lstm_problem()
    qp = qlinear.quantize_lstm(_torch_cell(lstm))
    with pytest.raises(ValueError, match="segments cover"):
        qlinear.qlstm_cell(qp, (torch.from_numpy(emb),),
                           torch.from_numpy(h), torch.from_numpy(c))


def test_quantized_decoder_tree_matches_jax():
    tree = np_decoder_tree(vocab=97, att=24, dec=40, emb=16, enc=64)
    ref = jax_quantize_decoder({k: v for k, v in tree.items()})
    ours = quantize_attention_decoder(decoder_from_jax(tree))
    _assert_trees_equal(qdecoder_to_jax(ours), ref)
    bridged = qdecoder_from_jax(ref)
    assert bridged.keys() == ours.keys()
    for part in ours:
        for key, t in ours[part].items():
            assert torch.equal(bridged[part][key], t), (part, key)
            assert bridged[part][key].stride() == t.stride(), (part, key)
