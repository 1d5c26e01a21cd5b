"""K1 (icd_tpu_torch/ops/fused_attention.py) vs icd_tpu's fused attention.

On the CPU the port's wrapper runs its plain version. It is held against
``icd_tpu.ops.fused_attention.fused_attention_reference`` and against
the Pallas kernel in interpret mode (as tests/test_fused_attention.py
runs it), at that file's tolerances: ctx atol 2e-5, alpha atol 2e-6
(f32, sums taken in a different order). The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py, which needs a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import icd_tpu.ops.fused_attention as jax_fa
from icd_tpu.models.attention import (AttentionDecoderParams,
                                      decode_step as jax_decode_step,
                                      init_attention_decoder,
                                      soft_attention as jax_soft_attention)
from icd_tpu_torch.models.attention import decode_step, soft_attention
from icd_tpu_torch.ops.fused_attention import (fused_attention,
                                               fused_attention_reference)
from icd_tpu_torch.params import decoder_from_jax


def _inputs(b=8, p=196, d=64, a=32, h_dim=48, rows=None, seed=0):
    """numpy inputs in the JAX layout (wd (H, A), wg (H, D))."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(enc=n(b, p, d), att_enc=n(b, p, a), h=n(rows or b, h_dim),
                wd=n(h_dim, a) * 0.3, bd=n(a) * 0.1, wf=n(a) * 0.3,
                bf=np.asarray([0.05], np.float32), wg=n(h_dim, d) * 0.3,
                bg=n(d) * 0.1)


def _jax_args(x):
    return tuple(jnp.asarray(x[k]) for k in
                 ("enc", "att_enc", "h", "wd", "bd", "wf", "bf", "wg", "bg"))


def _torch_args(x, device="cpu", dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(device=device, dtype=dtype)
         for k, v in x.items()}
    # nn.Linear layout: (out, in).
    t["wd"] = t["wd"].t().contiguous()
    t["wg"] = t["wg"].t().contiguous()
    return tuple(t[k] for k in
                 ("enc", "att_enc", "h", "wd", "bd", "wf", "bf", "wg", "bg"))


@pytest.mark.parametrize("b,p", [(8, 196), (4, 100)])
def test_plain_matches_jax_reference(b, p):
    x = _inputs(b=b, p=p)
    ref_ctx, ref_alpha = jax_fa.fused_attention_reference(*_jax_args(x))
    ctx, alpha = fused_attention(*_torch_args(x))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=2e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha),
                               atol=2e-6)


@pytest.mark.parametrize("b,p", [(8, 196), (4, 100)])
def test_plain_matches_pallas_interpret(monkeypatch, b, p):
    x = _inputs(b=b, p=p)
    with jax.disable_jit():
        monkeypatch.setattr(pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
        ref_ctx, ref_alpha = jax_fa.fused_attention_pallas.__wrapped__(
            *_jax_args(x))
    ctx, alpha = fused_attention(*_torch_args(x))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=2e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha),
                               atol=2e-6)


@pytest.mark.parametrize("k", [2, 5])
def test_rows_per_image_matches_repeated_grid(k):
    """k rows per image == the k = 1 call on a grid repeated k times."""
    x = _inputs(b=3, p=49, rows=3 * k)
    args = _torch_args(x)
    enc, att_enc = args[0], args[1]
    ctx, alpha = fused_attention(*args, rows_per_image=k)
    rep = (enc.repeat_interleave(k, 0), att_enc.repeat_interleave(k, 0))
    ctx1, alpha1 = fused_attention(*rep, *args[2:])
    np.testing.assert_allclose(ctx.numpy(), ctx1.numpy(), atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), alpha1.numpy(), atol=1e-7)


def _decoder_tree():
    class Cfg(AttentionDecoderParams):
        pass

    Cfg.attention_dim, Cfg.decoder_dim, Cfg.embed_size = 32, 48, 8
    Cfg.vocab = list(range(19))
    return jax.tree_util.tree_map(np.asarray, init_attention_decoder(
        jax.random.PRNGKey(0), Cfg(), encoder_dim=64))


def test_soft_attention_matches_jax():
    """The plain path of the JAX package (scores rounded to the activation
    dtype, here f32), which K1's f32 result agrees with."""
    dec = _decoder_tree()
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((4, 49, 64)).astype(np.float32)
    h = rng.standard_normal((4, 48)).astype(np.float32)
    ref_w, ref_alpha = jax_soft_attention(dec["attention"], jnp.asarray(enc),
                                          jnp.asarray(h))
    with torch.no_grad():
        w, alpha = soft_attention(decoder_from_jax(dec).attention,
                                  torch.from_numpy(enc), torch.from_numpy(h))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha),
                               atol=1e-6)


def test_decode_step_matches_jax():
    dec = _decoder_tree()
    rng = np.random.default_rng(3)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    enc, emb, h, c = n(4, 49, 64), n(4, 8), n(4, 48), n(4, 48)
    att_enc = enc @ dec["attention"]["enc_att"]["w"] \
        + dec["attention"]["enc_att"]["b"]
    ref = jax_decode_step(dec, jnp.asarray(enc), jnp.asarray(att_enc),
                          jnp.asarray(emb), jnp.asarray(h), jnp.asarray(c))
    t = lambda a: torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        out = decode_step(decoder_from_jax(dec), t(enc), t(att_enc), t(emb),
                          t(h), t(c))
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_phase_us_reads_the_clock():
    """K1's clock as the kernel writes it (ns): the gate launch's blocks
    (start, end), the attention launch's (start and the end of each
    phase); phase_us gives the median over blocks of each phase and the
    span from the first start to the last end."""
    from icd_tpu_torch.ops.fused_attention import PHASES, phase_us

    gate = torch.tensor([[0, 4000], [1000, 7000], [0, 5000]])
    att = torch.tensor([[500, 1500, 2500, 5500, 6500, 9000],
                        [1000, 3000, 4000, 6000, 7000, 8000]])
    us = phase_us(dict(gate=gate, attention=att))
    assert set(us) == set(PHASES) | {"span"}
    assert us["gate"] == 5.0  # the median of 4, 6 and 5 us
    assert us["att_dec"] == 1.0  # the lower median of 1 and 2 us
    assert us["context"] == 2.0 and us["store"] == 1.0
    assert us["span"] == 9.0
    with pytest.raises(ValueError):
        phase_us(dict(gate=gate, attention=att[:, :4]))
