"""icd_tpu_torch on a CUDA card: each kernel against its plain version.

Needs a card; every test skips without one. The file imports no jax, so
on a machine with a card and no jax it runs without the suite's
conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances. K1: f32 ctx atol 2e-5 and alpha atol 2e-6 (those of
tests/test_fused_attention.py; sums in another order); bf16 inputs
against the plain version in f32 on the same rounded inputs, ctx within
2^-8 |ref| + 1e-5 per element (the kernel rounds its f32 result to bf16
once, at most 2^-9 relative) and alpha atol 1e-5. K2: f32 tokens equal
and alphas atol 5e-6 (sums in another order); bf16 at least 15 of every
16 captions equal (at least 90 % on an N(0, 1) grid), since bf16-rounded
logits turn a last-bit difference of a sum into a different order of two
near-tie beams; bf16 step-1 alphas atol 1e-6 (the attention runs in f32
from the same bf16 operands, only the sums' order differs). K2's phase
clock within 10 % of CUDA events around the same launch (the card sleeps
while the host sets the launch up, so the events time only the launch),
and K1's likewise: the span from its first block's start to its last
block's end.
"""

import contextlib
import math

import pytest
import torch

import icd_tpu_torch.models.attention as attention
from icd_tpu_torch.decoding.beam import beam_search_batched
from icd_tpu_torch.decoding.serve import make_beam_captioner
from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                            init_attention_decoder)
from icd_tpu_torch.models.encoder import EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.ops import fused_beam
from icd_tpu_torch.ops.fused_attention import (fused_attention,
                                               fused_attention_reference)
from icd_tpu_torch.ops.fused_beam import (beam_search_fused,
                                          beam_search_fused_reference)
from icd_tpu_torch.testing import steered_decoder


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _k1_args(b, k, p, d, a, h, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n = lambda *s, scale=1.0: torch.randn(s, generator=gen) * scale
    return [n(b, p, d), n(b, p, a), n(b * k, h), n(a, h, scale=h ** -0.5),
            n(a, scale=0.1), n(a, scale=a ** -0.5), n(1, scale=0.1),
            n(d, h, scale=h ** -0.5), n(d, scale=0.1)]


# (images, rows per image, P, D, A, H): the serving layout scaled down,
# one row per image with ragged sizes, and the most rows a block takes.
SHAPES = [(6, 5, 196, 256, 64, 64), (3, 1, 100, 200, 72, 40),
          (2, 8, 49, 96, 24, 33)]


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_f32_matches_plain(card, shape):
    args = [t.to(card) for t in _k1_args(*shape)]
    k = shape[1]
    before = fused_attention.launches
    ctx, alpha = fused_attention(*args, rows_per_image=k)
    assert fused_attention.launches == before + 1
    ref_ctx, ref_alpha = fused_attention_reference(*args, rows_per_image=k)
    torch.testing.assert_close(ctx, ref_ctx, atol=2e-5, rtol=0)
    torch.testing.assert_close(alpha, ref_alpha, atol=2e-6, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_bf16_matches_plain_f32(card, shape):
    args = [t.to(card, torch.bfloat16) for t in _k1_args(*shape, seed=1)]
    k = shape[1]
    ctx, alpha = fused_attention(*args, rows_per_image=k)
    ref_ctx, ref_alpha = fused_attention_reference(
        *(t.float() for t in args), rows_per_image=k)
    assert ctx.dtype == torch.bfloat16 and alpha.dtype == torch.float32
    err = (ctx.float() - ref_ctx).abs()
    assert bool((err <= 2 ** -8 * ref_ctx.abs() + 1e-5).all()), err.max()
    torch.testing.assert_close(alpha, ref_alpha, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hdim", [20, 40])
def test_k1_bf16_depth_not_a_multiple_of_16(card, hdim):
    """The tensor-core products of h take 16-deep steps: a depth of 40
    ends in a zero-padded half step, one of 20 also takes its rows a
    value at a time (rows of 40 bytes are not whole 16-byte words)."""
    shape = (4, 5, 49, 256, 64, hdim)
    args = [t.to(card, torch.bfloat16) for t in _k1_args(*shape, seed=2)]
    ctx, alpha = fused_attention(*args, rows_per_image=5)
    ref_ctx, ref_alpha = fused_attention_reference(
        *(t.float() for t in args), rows_per_image=5)
    err = (ctx.float() - ref_ctx).abs()
    assert bool((err <= 2 ** -8 * ref_ctx.abs() + 1e-5).all()), err.max()
    torch.testing.assert_close(alpha, ref_alpha, atol=1e-5, rtol=0)


def _k1_against_plain(card, shape, dtype, seed):
    args = [t.to(card, dtype) for t in _k1_args(*shape, seed=seed)]
    k = shape[1]
    ctx, alpha = fused_attention(*args, rows_per_image=k)
    ref_ctx, ref_alpha = fused_attention_reference(
        *(t.float() for t in args), rows_per_image=k)
    assert ctx.dtype == dtype and alpha.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(ctx, ref_ctx, atol=2e-5, rtol=0)
        torch.testing.assert_close(alpha, ref_alpha, atol=2e-6, rtol=0)
    else:
        err = (ctx.float() - ref_ctx).abs()
        assert bool((err <= 2 ** -8 * ref_ctx.abs() + 1e-5).all()), err.max()
        torch.testing.assert_close(alpha, ref_alpha, atol=1e-5, rtol=0)


# (images, rows per image, P, D, A, H). The attention launch splits P
# over a cluster of 3 blocks in chunks of ceil(P / 3): P = 1 leaves two
# blocks empty, 7 and 13 leave the last block short, 196 is the serving
# P. k = 1, 5 and 8 beams. D = 100 and A = 36 in bf16 (and D = 102 in
# f32) are not whole 16-byte words; D = 1030 splits unevenly over the
# cluster's 3 column shares, A = 80 over its att_dec shares (32, 32,
# 16); H = 40 is not a multiple of the 32-deep slices of att_dec's
# product.
K1_SHAPES = [(3, 5, 1, 64, 32, 32), (3, 5, 7, 64, 32, 32),
             (2, 8, 13, 128, 64, 64), (4, 1, 196, 256, 64, 64),
             (2, 5, 196, 2048, 512, 512), (3, 5, 49, 100, 36, 40),
             (3, 8, 30, 102, 36, 40), (2, 5, 49, 1030, 80, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_cluster_splits_match_plain(card, shape, dtype):
    _k1_against_plain(card, shape, dtype, seed=3)


def test_k1_is_deterministic(card):
    """The cluster combines its blocks' partial sums in a fixed order:
    two launches on the same operands give the same bits."""
    args = [t.to(card, torch.bfloat16)
            for t in _k1_args(8, 5, 196, 2048, 512, 512, seed=4)]
    runs = [fused_attention(*args, rows_per_image=5) for _ in range(3)]
    for ctx, alpha in runs[1:]:
        assert torch.equal(ctx, runs[0][0])
        assert torch.equal(alpha, runs[0][1])


def test_k1_phase_clock(card):
    """Every block stamps its phases in order, and the span from the
    first block's start to the last block's end accounts for the CUDA
    events around the same call within 10 %."""
    from icd_tpu_torch.ops.fused_attention import PHASES, _launch, phase_us

    args = [t.to(card, torch.bfloat16)
            for t in _k1_args(64, 5, 196, 2048, 512, 512, seed=5)]
    _launch(*args, 5)  # warm-up
    begin = torch.cuda.Event(enable_timing=True)
    finish = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the host's set-up ends before `begin`
    begin.record()
    _, _, clock = _launch(*args, 5)
    finish.record()
    finish.synchronize()
    gate, att = clock["gate"].cpu(), clock["attention"].cpu()
    assert gate.shape[1] == 2 and att.shape[1] == len(PHASES)
    assert att.shape[0] % 64 == 0  # a cluster of blocks per image
    assert bool((gate.diff(dim=1) >= 0).all())
    assert bool((att.diff(dim=1) >= 0).all())
    us = phase_us(clock)
    assert set(us) == set(PHASES) | {"span"}
    event_us = begin.elapsed_time(finish) * 1e3
    assert abs(us["span"] - event_us) <= 0.1 * event_us, (us, event_us)


def test_k1_rejects_what_it_does_not_take(card):
    args = [t.to(card) for t in _k1_args(2, 3, 16, 32, 8, 8)]
    with pytest.raises(TypeError):
        fused_attention(*(t.half() for t in args), rows_per_image=3)
    with pytest.raises(TypeError):
        fused_attention(args[0].bfloat16(), *args[1:], rows_per_image=3)
    with pytest.raises(ValueError):
        fused_attention(*args, rows_per_image=2)  # h has 6 rows, not 4
    with pytest.raises(ValueError):
        h = torch.randn(8, 6, device=card).t()  # (6, 8), not contiguous
        fused_attention(args[0], args[1], h, *args[3:], rows_per_image=3)
    wide = [t.to(card) for t in _k1_args(1, 9, 16, 32, 8, 8)]
    with pytest.raises(ValueError):
        fused_attention(*wide, rows_per_image=9)
    # D beyond 256 threads x 8 columns of the context sum.
    with pytest.raises(ValueError, match="D <="):
        fused_attention(*(t.to(card) for t in _k1_args(1, 2, 4, 2049, 8, 8)),
                        rows_per_image=2)
    # att_dec rows (k, A) f32 beyond a block's shared memory.
    with pytest.raises(ValueError, match="shared"):
        fused_attention(*(t.to(card, torch.bfloat16)
                          for t in _k1_args(1, 8, 4, 64, 8192, 8)),
                        rows_per_image=8)
    # ... and a good launch after the refusals.
    _k1_against_plain(card, K1_SHAPES[0], torch.float32, seed=0)


@contextlib.contextmanager
def _plain_attention():
    kernel = attention.fused_attention
    attention.fused_attention = fused_attention_reference
    try:
        yield
    finally:
        attention.fused_attention = kernel


def _decoder(card, vocab=60, enc_dim=64):
    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim, params.embed_size = 32, 48, 16
    params.vocab = range(vocab)
    return init_attention_decoder(torch.Generator().manual_seed(0), params,
                                  encoder_dim=enc_dim, device=card)


def test_beam_search_through_k1_matches_plain(card):
    dec = _decoder(card)
    grids = torch.randn(5, 49, 64, generator=torch.Generator().manual_seed(2))
    grids = grids.to(card)
    before = fused_attention.launches
    out = beam_search_batched(dec, grids, 5, 57, 58, max_steps=9)
    assert fused_attention.launches - before == out["steps"]
    with _plain_attention():
        ref = beam_search_batched(dec, grids, 5, 57, 58, max_steps=9)
    for key in ("seq", "seq_len", "found"):
        assert torch.equal(out[key], ref[key]), key
    torch.testing.assert_close(out["alphas"], ref["alphas"], atol=5e-6,
                               rtol=0)


def test_captioner_on_card_matches_cpu(card):
    """The whole slice in f32 with TF32 off: card == CPU, token for token."""
    gen = torch.Generator().manual_seed(3)
    encoder = EncoderAttention(init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16),
                                           device="cpu"))
    decoder = _decoder("cpu")
    imgs = torch.randint(0, 256, (3, 64, 64, 3), generator=gen,
                         dtype=torch.uint8)
    outs = [make_beam_captioner(encoder, decoder, 57, 58, beam_size=3,
                                compute_dtype=torch.float32,
                                device=dev)(imgs)
            for dev in (card, "cpu")]
    for key in ("seq", "seq_len", "found"):
        assert torch.equal(outs[0][key].cpu(), outs[1][key]), key
    torch.testing.assert_close(outs[0]["alphas"].cpu(), outs[1]["alphas"],
                               atol=1e-4, rtol=0)


# (images, beams, P, D, A, H, E, V, max_steps): ragged sizes, one beam,
# the most beams K2 takes, and 70 rows (more than one 64-row tile).
K2_SHAPES = [(3, 3, 49, 200, 40, 48, 24, 997, 9),
             (4, 1, 16, 64, 24, 32, 16, 40, 7),
             (2, 8, 20, 96, 33, 40, 8, 123, 12),
             (14, 5, 49, 128, 32, 48, 16, 500, 12)]


def _k2_problem(card, shape, dtype, seed=0):
    b, k, p, d, a, h, e, v, steps = shape
    dec = steered_decoder(v, a, h, e, d, seed, device=card).to(dtype)
    grids = torch.randn(b, p, d, generator=torch.Generator().manual_seed(
        seed + 1)).to(card, dtype)
    return dec, grids, k, v - 3, v - 2, steps


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_f32_matches_plain(card, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    dec, grids, k, start, end, steps = _k2_problem(card, shape, torch.float32)
    before = beam_search_fused.launches
    out = beam_search_fused(dec, grids, k, start, end, steps)
    assert beam_search_fused.launches == before + 1
    ref = beam_search_fused_reference(dec, grids, k, start, end, steps)
    loop = beam_search_batched(dec, grids, k, start, end, steps)
    for key in ("seq", "seq_len", "found"):
        assert torch.equal(out[key], ref[key]), key
        assert torch.equal(out[key], loop[key]), key
    assert out["steps"] == ref["steps"] == loop["steps"]
    torch.testing.assert_close(out["alphas"], ref["alphas"], atol=5e-6,
                               rtol=0)


def test_k2_bf16_matches_plain(card):
    shape = (32, 5, 49, 128, 32, 48, 16, 500, 12)
    dec, grids, k, start, end, steps = _k2_problem(card, shape,
                                                   torch.bfloat16, seed=3)
    out = beam_search_fused(dec, grids, k, start, end, steps)
    ref = beam_search_fused_reference(dec, grids, k, start, end, steps)
    same = int((out["seq"] == ref["seq"]).all(dim=1).sum())
    assert same >= 30, same
    assert bool(out["alphas"].isfinite().all())


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_bf16_at_every_shape(card, shape):
    """K2 in bf16 (tensor-core products, 16-byte streams, bf16 logits)
    at ragged sizes, one beam, eight beams and 70 rows: step 1's raw
    alphas against the plain version's, and the captions on an N(0, 1)
    grid."""
    dec, grids, k, start, end, steps = _k2_problem(card, shape,
                                                   torch.bfloat16, seed=5)
    ops = fused_beam._operands(dec, grids)
    first = fused_beam._launch(ops, k, start, end, 1)
    first_ref = fused_beam._search_plain(ops, k, start, end, 1)
    torch.testing.assert_close(first["alpha"][1], first_ref["alpha"][1],
                               atol=1e-6, rtol=0)
    out = beam_search_fused(dec, grids, k, start, end, steps)
    ref = beam_search_fused_reference(dec, grids, k, start, end, steps)
    same = int((out["seq"] == ref["seq"]).all(dim=1).sum())
    assert same >= math.ceil(0.9 * grids.shape[0]), (same, grids.shape[0])


def test_k2_bf16_is_deterministic(card):
    """Launches on the same operands give the same bits: no sum depends
    on the order in which blocks or threads run. (Rows of the history
    after the last step are never written, and not compared.)"""
    dec, grids, k, start, end, steps = _k2_problem(card, K2_SHAPES[3],
                                                   torch.bfloat16, seed=3)
    ops = fused_beam._operands(dec, grids)
    runs = [fused_beam._launch(ops, k, start, end, steps) for _ in range(3)]
    n = runs[0]["steps"] + 1
    for raw in runs[1:]:
        assert raw["steps"] + 1 == n
        for key in ("alpha", "parent"):
            assert torch.equal(runs[0][key][:n], raw[key][:n]), key
        for key in ("best_seq", "best_len", "best_step", "found"):
            assert torch.equal(runs[0][key], raw[key]), key


def test_k2_phase_clock(card):
    """One clock row per step run, rising, and summing to the launch's
    time by CUDA events within 10 %."""
    shape = (64, 5, 196, 512, 128, 128, 64, 4000, 16)
    dec, grids, k, start, end, steps = _k2_problem(card, shape,
                                                   torch.bfloat16, seed=6)
    ops = fused_beam._operands(dec, grids)
    fused_beam._launch(ops, k, start, end, steps)  # warm-up
    begin = torch.cuda.Event(enable_timing=True)
    finish = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the host's set-up ends before `begin`
    begin.record()
    raw = fused_beam._start(ops, k, start, end, steps)
    finish.record()
    finish.synchronize()
    run = int(raw["steps"].item())
    clock = raw["phase_ns"].cpu()
    n = len(fused_beam.PHASES)
    assert clock.shape == (steps + 1, n + 1)
    assert bool((clock[1:run + 1] > 0).all())  # one row per step run
    assert bool((clock[run + 1:] == 0).all())
    stamps = torch.cat([clock[0, :2], clock[1:run + 1].flatten()])
    assert bool((stamps.diff() > 0).all())
    ms = fused_beam.phase_ms(clock, run)
    event_ms = begin.elapsed_time(finish)
    assert abs(ms["total"] - event_ms) <= 0.1 * event_ms, (ms, event_ms)
    assert sum(ms[name] for name in fused_beam.PHASES) <= ms["total"]


def test_k2_rejects_what_it_does_not_take(card):
    dec, grids, k, start, end, steps = _k2_problem(card, K2_SHAPES[0],
                                                   torch.float32)
    with pytest.raises(TypeError):  # half precision
        beam_search_fused(dec.half(), grids.half(), k, start, end, steps)
    with pytest.raises(TypeError):  # grid and decoder of two dtypes
        beam_search_fused(dec.float(), grids.bfloat16(), k, start, end,
                          steps)
    with pytest.raises(ValueError):  # more beams than a block takes
        beam_search_fused(dec.float(), grids.float(), 9, start, end, steps)
    with pytest.raises(ValueError):
        beam_search_fused(dec.float(), grids.float(), k, start, end, 0)
    with pytest.raises(ValueError):
        beam_search_fused(dec.float(), grids.float(), k, start, 10 ** 6,
                          steps)
    # (k + 1) * A floats of att_dec rows exceed a block's shared memory:
    # the kernel's launch set-up refuses, and the wrapper raises its error.
    wide = steered_decoder(40, 8192, 32, 16, 64, seed=0, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        beam_search_fused(wide, torch.randn(2, 16, 64, device=card), 8, 37,
                          38, 3)
    # ... and leaves no error behind to fail the next good launch.
    out = beam_search_fused(dec.float(), grids.float(), k, start, end, steps)
    assert out["steps"] >= 1


def test_fused_captioner_on_card_matches_cpu(card):
    """The fused slice in f32 with TF32 off: K2 on the card == its plain
    version on the CPU, token for token."""
    gen = torch.Generator().manual_seed(3)
    encoder = EncoderAttention(init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16),
                                           device="cpu"))
    decoder = steered_decoder(60, 32, 48, 16, 64, seed=0, device="cpu")
    imgs = torch.randint(0, 256, (3, 64, 64, 3), generator=gen,
                         dtype=torch.uint8)
    outs = [make_beam_captioner(encoder, decoder, 57, 58, beam_size=3,
                                compute_dtype=torch.float32, device=dev,
                                beam_fn=beam_search_fused)(imgs)
            for dev in (card, "cpu")]
    for key in ("seq", "seq_len", "found"):
        assert torch.equal(outs[0][key].cpu(), outs[1][key]), key
    torch.testing.assert_close(outs[0]["alphas"].cpu(), outs[1]["alphas"],
                               atol=1e-4, rtol=0)
