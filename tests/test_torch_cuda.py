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
block's end. The int8 products (``torch._int_mm``, cuBLASLt) sum
integers: card and CPU give the same int32 sums, and the int8 encoder
the same grid. Greedy captioners in f32 with TF32 off give the same
tokens on card and CPU. Training: one f32 step of each model family agrees on card and CPU,
and so do one --amp step and one --int8_encoder step of each (the limits
are at the tests); the train and eval drivers of both families, with
--amp and --int8_encoder, run on the card by default and launch neither
K1 nor K2. BERT: the aligned caption embeddings in f32 within 1e-5 of the
CPU's largest value; the W8A8 form with the CPU's int8 inputs shared:
every product's int32 sums equal, its inputs and output within 1e-5, and
free-running its output within 1e-3; one --use_bert step within the f32
step's limits. The multi-chip path: three f32 steps on a one-rank NCCL
mesh equal, to the bit, the same steps without a mesh (the mesh path
keeps the same operations); vocab-parallel gradients on CUDA tensors
through two gloo ranks sharing the card within 1e-6 of the unsplit
decoder's. The port's JPEG codec, built by the card machine's g++,
decodes ``testing.codec_corpus()`` to ``CODEC_CORPUS_DIGEST`` (PIL's
pixels, proven on the CPU by tests/test_torch_jpeg.py), and
``python -m icd_tpu_torch.bench_serving_e2e`` runs 2 batches on the card
with the end-to-end captions equal to the resident batch's.
"""

import contextlib
import copy
import functools
import json
import math
import os

import pytest
import torch

import icd_tpu_torch.decoding.beam as beam
import icd_tpu_torch.models.attention as attention
from icd_tpu_torch.decoding.beam import beam_search_batched
from icd_tpu_torch.decoding.serve import (make_beam_captioner,
                                          make_captioner,
                                          make_int8_attention_captioner,
                                          make_int8_captioner)
from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                            init_attention_decoder)
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.encoder import (Encoder, EncoderAttention,
                                          encoder_attention_forward)
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.models.resnet_int8 import calibrate_act_maxes
from icd_tpu_torch.ops import fused_beam
from icd_tpu_torch.ops.fused_attention import (fused_attention,
                                               fused_attention_reference)
from icd_tpu_torch.ops.fused_beam import (beam_search_fused,
                                          beam_search_fused_reference)
from icd_tpu_torch.ops.image import resize_bilinear
from icd_tpu_torch.ops.qlinear import qmatmul, quantize_linear
from icd_tpu_torch.ops.quant import conv2d_int8, gemm_layout, int_mm
from icd_tpu_torch.params import adam_moments
from icd_tpu_torch.testing import (SCORE_BIAS, SharedQuantization,
                                   decoder_grads, k2_step_record,
                                   plain_step_record, relative_errors,
                                   seeded_captions, steer_end,
                                   steered_decoder, train_step_errors,
                                   train_step_record)


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


def test_beam_step_graph_equals_the_uncaptured_step(card):
    """Each beam step as one replay of its CUDA graph against the same
    step run uncaptured: every output to the bit, and K1 counted once a
    step, at the serving widths in bf16 (images finishing at different
    steps), with one and eight beams, the int8 grid, searches cut off by
    max_steps, two searches in turn through one graph, and a new batch
    size taking a graph of its own."""
    def same(dec, grids, k, max_steps=12, int8_grid=False):
        end = dec.vocab_size - 2
        before = fused_attention.launches
        out = beam_search_batched(dec, grids, k, end - 1, end, max_steps,
                                  int8_grid)
        assert fused_attention.launches - before == out["steps"]
        ref = beam._beam_search(dec, grids, k, end - 1, end, max_steps,
                                int8_grid, captured=False)
        assert out["steps"] == ref["steps"]
        for key in ("seq", "seq_len", "found", "alphas"):
            assert torch.equal(out[key], ref[key]), key
        return out

    gen = torch.Generator().manual_seed(1)
    wide = steered_decoder(10000, 512, 512, 512, 2048, seed=1, device=card)
    steer_end(wide, 9998)  # as the serving cells steer: 11 to 16 words
    wide = wide.to(torch.bfloat16)
    grids = torch.randn(64, 196, 2048, generator=gen).to(card, torch.bfloat16)
    out = same(wide, grids, 5, max_steps=beam.MAX_STEPS)
    assert out["steps"] < beam.MAX_STEPS
    assert len(set(out["seq_len"].tolist())) > 1
    same(wide, grids, 5, max_steps=beam.MAX_STEPS, int8_grid=True)

    dec = steered_decoder(60, 32, 48, 16, 64, seed=0, device=card)
    grids = torch.randn(6, 49, 64, generator=gen).to(card)
    for k in (1, 8):
        same(dec, grids, k)
    cut = same(dec, grids, 5, max_steps=3)
    assert cut["steps"] == 3 and not bool(cut["found"].all())
    first = same(dec, grids, 5)
    kept = {key: v.clone() for key, v in first.items() if key != "steps"}
    n_graphs = len(beam._GRAPHS[dec])
    second = same(dec, torch.randn(6, 49, 64, generator=gen).to(card), 5)
    assert len(beam._GRAPHS[dec]) == n_graphs
    assert not torch.equal(second["alphas"], first["alphas"])
    for key, v in kept.items():  # no output aliases the graph's state
        assert torch.equal(first[key], v), key
    same(dec, grids[:3], 5)
    assert len(beam._GRAPHS[dec]) == n_graphs + 1


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_workspace_views(card, dtype):
    """K2 stopped after each step and read through its workspace views
    (``ops.fused_beam._scratch``, testing.k2_step_record): each stopped
    launch's parents and alphas equal the full launch's, bit for bit;
    its stored scores equal the candidates rebuilt from the views,
    (logits - lse) + the running scores of the launch before, bit for
    bit, and its choice is their top-k; each live row's lse is its
    logits' log-sum-exp within 1e-5. In f32 its choices equal the plain
    version's at every step and its candidates lie within 1e-4 of them
    (f32 sums in another order over 12 steps of scores near -75)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dec, grids, k, start, end, steps = _k2_problem(card, K2_SHAPES[3],
                                                   dtype)
    ops = fused_beam._operands(dec, grids)
    b, v = grids.shape[0], ops["emb"].shape[0]
    images = list(range(b))
    rec = k2_step_record(ops, k, start, end, steps, images)
    assert rec["prefix_equal"]
    assert sorted(rec["choices"]) == list(range(1, steps + 1))
    for t in rec["choices"]:
        assert bool(rec["consistent"][t].all()), t
    raw = fused_beam._launch(ops, k, start, end, 3)
    sc = raw["scratch"]
    live = torch.arange(k, device=card) < fused_beam._launch(
        ops, k, start, end, 2)["scratch"]["kact"].long()[:, None]
    lse = torch.logsumexp(sc["logits"].float(), dim=1).view(b, k)
    torch.testing.assert_close(sc["lse"].view(b, k)[live], lse[live],
                               atol=1e-5, rtol=0)
    if dtype == torch.float32:
        plain = plain_step_record(ops, k, start, end, steps, images)
        for t, choice in plain["choices"].items():
            assert torch.equal(rec["choices"][t], choice), t
            torch.testing.assert_close(rec["cands"][t], plain["cands"][t],
                                       atol=1e-4, rtol=0)


def test_resize_bilinear_card_matches_cpu(card):
    """ops.image.resize_bilinear (F.interpolate, antialiased) on the card
    against the CPU at 480x640 -> 224x224, uint8 in: within 2e-3 on the
    0-255 scale, the limit it is held to against JAX (f32 sums over the
    antialias taps in another order)."""
    imgs = torch.randint(0, 256, (4, 480, 640, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    out = resize_bilinear(imgs.to(card), (224, 224))
    assert out.dtype == torch.float32 and out.shape == (4, 224, 224, 3)
    torch.testing.assert_close(out.cpu(), resize_bilinear(imgs, (224, 224)),
                               atol=2e-3, rtol=0)


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


def test_k1_one_row_per_image_at_serving_shapes(card):
    """Greedy decoding's shape: 64 images, one row each, P=196, D=2048,
    A=H=512, f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        _k1_against_plain(card, (64, 1, 196, 2048, 512, 512), dtype, seed=7)


# (B, H, W, Cin, kernel, Cout, stride, padding): the stem (K = 147
# padded to 152), 1x1 and 3x3 sites, a 1x1 stride-2 downsample, and
# widths that are not multiples of 8 (padded for cuBLASLt).
INT8_CONV_SHAPES = [
    (2, 224, 224, 3, 7, 64, 2, 3), (2, 56, 56, 256, 1, 64, 1, 0),
    (2, 56, 56, 128, 3, 128, 2, 1), (2, 14, 14, 256, 3, 256, 1, 1),
    (2, 28, 28, 512, 1, 1024, 2, 0), (3, 9, 9, 12, 3, 4, 1, 1),
    (1, 4, 4, 20, 1, 5, 1, 0)]


@pytest.mark.parametrize("shape", INT8_CONV_SHAPES)
def test_conv2d_int8_card_equals_cpu(card, shape):
    b, h, w, cin, k, cout, stride, pad = shape
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                      dtype=torch.int8)
    wq = gemm_layout(torch.randint(-127, 128, (k, k, cin, cout),
                                   generator=gen, dtype=torch.int8))
    out = conv2d_int8(x.to(card), wq.to(card), stride, pad)
    assert out.dtype == torch.int32
    assert torch.equal(out.cpu(), conv2d_int8(x, wq, stride, pad))


# (M, K, N): rows fewer than 17, N not a multiple of 8, the decoder's
# LSTM and fc shapes at batch 64.
QMM_SHAPES = [(5, 512, 10000), (16, 48, 97), (64, 2048, 2048),
              (64, 512, 9490), (17, 20, 9)]


@pytest.mark.parametrize("shape", QMM_SHAPES)
def test_qmatmul_card_equals_cpu(card, shape):
    m, k, n = shape
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen)
    wq, ws = quantize_linear(torch.randn(k, n, generator=gen) * 0.05)
    xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    acc = int_mm(xq.to(card), wq.to(card), n)
    assert acc.shape == (m, n)
    assert torch.equal(acc.cpu(), int_mm(xq, wq, n))
    assert torch.equal(qmatmul(x.to(card), wq.to(card), ws.to(card)).cpu(),
                       qmatmul(x, wq, ws))


def _small_int8_problem():
    gen = torch.Generator().manual_seed(3)
    encoder = EncoderAttention(init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16),
                                           device="cpu"))
    imgs = torch.randint(0, 256, (3, 64, 64, 3), generator=gen,
                         dtype=torch.uint8)
    act_maxes = calibrate_act_maxes(encoder.resnet, imgs, torch.float32)
    return encoder, imgs, act_maxes


@pytest.mark.parametrize("int8_decoder", [False, True])
def test_int8_greedy_captioner_on_card_matches_cpu(card, int8_decoder):
    """The int8 encoder and greedy decoding in f32 with TF32 off, on the
    same act_maxes: card == CPU, token for token."""
    encoder, imgs, act_maxes = _small_int8_problem()
    decoder = steered_decoder(60, 32, 48, 16, 64, seed=0, device="cpu")
    outs = [make_int8_attention_captioner(
        encoder, decoder, 57, 58, max_len=12, compute_dtype=torch.float32,
        act_maxes=act_maxes, int8_decoder=int8_decoder, device=dev)(imgs)
        for dev in (card, "cpu")]
    assert torch.equal(outs[0][0].cpu(), outs[1][0])
    torch.testing.assert_close(outs[0][1].cpu(), outs[1][1], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("path", ["float", "dynamic_int8", "static_int8"])
def test_baseline_captioner_on_card_matches_cpu(card, path):
    """The baseline model's greedy serving in f32 with TF32 off: the float
    backbone, its dynamic-int8 convolutions, and the static-int8 backbone
    with the W8A8 decoder: card == CPU, token for token."""
    encoder, imgs, act_maxes = _small_int8_problem()
    gen = torch.Generator().manual_seed(4)
    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size, params.hidden_size = 60, 16, 48
    decoder = init_baseline_decoder(gen, params, device="cpu")
    head = Encoder(encoder.resnet, torch.nn.Linear(64, 16))
    if path == "static_int8":
        make = functools.partial(make_int8_captioner, act_maxes=act_maxes,
                                 int8_decoder=True)
    else:
        make = functools.partial(make_captioner,
                                 int8=path == "dynamic_int8")
    outs = [make(head, decoder, 57, 58, max_len=12,
                 compute_dtype=torch.float32, device=dev)(imgs)
            for dev in (card, "cpu")]
    assert outs[1].shape == (3, 12)
    assert torch.equal(outs[0].cpu(), outs[1])


@pytest.mark.parametrize("loop", ["per_step", "int8_grid", "fused"])
def test_int8_beam_captioner_on_card_matches_cpu(card, loop):
    encoder, imgs, act_maxes = _small_int8_problem()
    decoder = steered_decoder(60, 32, 48, 16, 64, seed=0, device="cpu")
    beam_fn = {"per_step": beam_search_batched,
               "int8_grid": functools.partial(beam_search_batched,
                                              int8_grid=True),
               "fused": beam_search_fused}[loop]
    outs = [make_beam_captioner(encoder, decoder, 57, 58, beam_size=3,
                                compute_dtype=torch.float32, device=dev,
                                beam_fn=beam_fn, act_maxes=act_maxes)(imgs)
            for dev in (card, "cpu")]
    for key in ("seq", "seq_len", "found"):
        assert torch.equal(outs[0][key].cpu(), outs[1][key]), key
    torch.testing.assert_close(outs[0]["alphas"].cpu(), outs[1]["alphas"],
                               atol=1e-4, rtol=0)


def _small_train_problem(seed=6):
    """A (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16), a steered V = 60
    decoder (A = 32, H = 48, E = 16), 4 images, captions of length 12."""
    gen = torch.Generator().manual_seed(seed)
    encoder = EncoderAttention(init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16),
                                           device="cpu"))
    decoder = steered_decoder(60, 32, 48, 16, 64, seed, device="cpu")
    imgs = torch.randint(0, 256, (4, 64, 64, 3), generator=gen,
                         dtype=torch.uint8)
    captions = seeded_captions(gen, 4, 12, 60, 57, 58, min_words=4)
    return encoder, decoder, imgs, captions, torch.full((4,), 11,
                                                        dtype=torch.int32)


def test_train_step_on_card_matches_cpu(card):
    """One f32 train step with TF32 off (dropout 0, clipping biting).

    From one grid the decoder's gradients agree within 1e-5 of each
    tensor's largest value (sums in other orders). Through each device's
    own grid, the loss within rtol 1e-5 and the new BN statistics within
    1e-5; an element of relu(att_enc + att_dec) within the grids'
    difference of zero takes the other branch on the other device, so
    gradients and Adam's moments are held to 1e-2 of their largest value,
    and the updated parameters to at most 1 % of elements more than
    lr / 100 apart (one step is below lr on each side, so no element can
    be 2 lr apart). The score bias's gradient is zero in exact
    arithmetic: noise below 1e-6.
    """
    encoder, decoder, imgs, captions, lens = _small_train_problem()
    lr = 1e-3
    card_run, cpu_run = (train_step_record(encoder, decoder, imgs, captions,
                                           lens, dev, lr=lr, grad_clip=0.05)
                         for dev in (card, "cpu"))
    errs = train_step_errors(card_run, cpu_run, lr)
    assert errs["loss"] <= 1e-5 and max(errs["score_bias_grad"]) < 1e-6
    assert max(errs["bn"].values()) <= 1e-5, errs["bn"]
    for key in ("grads", "exp_avg", "exp_avg_sq"):
        assert max(errs[key].values()) <= 1e-2, (key, errs[key])
    assert errs["step_share_beyond"] <= 1e-2
    with torch.no_grad():
        grid, _ = encoder_attention_forward(encoder, imgs, train=True)
    same = [decoder_grads(decoder, grid, captions, lens, dev)
            for dev in (card, "cpu")]
    for grads in same:
        assert grads.pop(SCORE_BIAS).abs().max() < 1e-6
    errs = relative_errors(*same)
    assert max(errs.values()) <= 1e-5, errs


class _MemoryVocab:
    """The four special tokens of a 60-word vocabulary."""

    w2i = {"<pad>": 0, "<start>": 57, "<end>": 58, "<unk>": 59}

    def __call__(self, word):
        return self.w2i.get(word, 59)

    def __len__(self):
        return 60


class _MemoryCaptions:
    """COCODataset's interface over six seeded in-memory items (no PIL,
    no files): (img, caption) in train mode, and in val mode also a
    path and the image's captions."""

    def __init__(self, mode, caption_max_len=-1):
        gen = torch.Generator().manual_seed(8 if mode == "train" else 9)
        self.mode, self.vocab = mode, _MemoryVocab()
        self.imgs = torch.randint(0, 256, (6, 64, 64, 3), generator=gen,
                                  dtype=torch.uint8).numpy()
        self.captions = [row[:int((row != 0).sum())].numpy() for row in
                         seeded_captions(gen, 6, 10, 60, 57, 58, min_words=3)]

    def __len__(self):
        return 6

    def __getitem__(self, i):
        if self.mode == "train":
            return self.imgs[i], self.captions[i]
        return self.imgs[i], self.captions[i], "img{}".format(i), [
            self.captions[i]]


def test_train_and_eval_drivers_run_on_the_card(card, tmp_path,
                                                monkeypatch):
    """training.attention.train and evaluate with no device given run on
    the card (two epochs over in-memory items, then eval of the saved
    trees), and neither launches K1 or K2."""
    import argparse

    import icd_tpu_torch.training.attention as ta
    from icd_tpu_torch.checkpoint import load_checkpoint

    monkeypatch.setenv("ICD_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("ICD_TPU_ALLOW_NO_METEOR", "1")
    monkeypatch.setattr(ta, "COCODataset", _MemoryCaptions)
    monkeypatch.setattr(ta, "init_encoder_attention", lambda gen, device:
                        EncoderAttention(init_resnet(gen, (1, 1, 1, 1),
                                                     (4, 8, 8, 16),
                                                     device=device)))
    monkeypatch.setattr(ta, "init_attention_decoder", functools.partial(
        init_attention_decoder, encoder_dim=64))
    args = argparse.Namespace(
        model_name="card", model="attention", attention_dim=32,
        decoder_dim=48, decoder_dropout=0.5, embed_size=16, epochs=2,
        batch_size=4, workers=0, encoder_lr=1e-4, decoder_lr=1e-3,
        grad_clip=5.0, alpha_c=1.0, fine_tune_encoder=False,
        fine_tune_embedding=False, checkpoint=None, print_freq=1,
        use_glove=False, max_caption_length=-1, use_bert=False)
    fused_attention.launches = beam_search_fused.launches = 0
    encoder, decoder = ta.train(args)
    assert next(decoder.parameters()).device.type == "cuda"
    assert next(encoder.parameters()).device.type == "cuda"
    chkpt = load_checkpoint(name="card_1.ckpt")
    losses = chkpt["metrics"]["epoch_losses"]
    assert len(losses) == 2 and all(len(e) == 2 for e in losses)
    assert int(adam_moments(chkpt["decoder_optimizer"])["count"]) == 4
    metrics = ta.evaluate(args, chkpt["encoder"], chkpt["decoder"])
    assert len(metrics["losses"]) == 6
    assert all(math.isfinite(v) for v in metrics["losses"])
    assert (fused_attention.launches, beam_search_fused.launches) == (0, 0)


def _small_baseline_problem(seed=6):
    """A (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16) with a Linear(64, 16)
    head, a V = 60, E = 16, H = 48 baseline decoder, 4 images, captions
    of length 12 (<pad> 0)."""
    gen = torch.Generator().manual_seed(seed)
    resnet = init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    embed = torch.nn.Linear(64, 16)
    with torch.no_grad():
        for p in embed.parameters():
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) / 8)
    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size, params.hidden_size = 60, 16, 48
    decoder = init_baseline_decoder(gen, params, device="cpu")
    imgs = torch.randint(0, 256, (4, 64, 64, 3), generator=gen,
                         dtype=torch.uint8)
    captions = seeded_captions(gen, 4, 12, 60, 57, 58, min_words=4)
    return Encoder(resnet, embed), decoder, imgs, captions


def test_baseline_train_step_on_card_matches_cpu(card):
    """One f32 baseline step with TF32 off, clipping biting, the head
    trained (--fine_tune_encoder): the features differ by the
    convolutions' sums in other orders and the LSTM has no kink, so the
    loss within rtol 1e-5, BN statistics within 1e-5, gradients and
    Adam's moments within 1e-3 of each tensor's largest value, at most 1
    % of the updated parameters more than lr / 100 apart."""
    encoder, decoder, imgs, captions = _small_baseline_problem()
    lr = 1e-3
    card_run, cpu_run = (train_step_record(encoder, decoder, imgs, captions,
                                           None, dev, lr=lr, grad_clip=0.05)
                         for dev in (card, "cpu"))
    assert {"embed.weight", "embed.bias"} <= set(card_run["grads"])
    errs = train_step_errors(card_run, cpu_run, lr)
    assert errs["loss"] <= 1e-5 and errs["score_bias_grad"] == []
    assert max(errs["bn"].values()) <= 1e-5, errs["bn"]
    for key in ("grads", "exp_avg", "exp_avg_sq"):
        assert max(errs[key].values()) <= 1e-3, (key, errs[key])
    assert errs["step_share_beyond"] <= 1e-2


def _problem(family):
    if family == "baseline":
        encoder, decoder, imgs, captions = _small_baseline_problem()
        return encoder, decoder, imgs, captions, None
    return _small_train_problem()


@pytest.mark.parametrize("family", ["baseline", "attention"])
def test_amp_step_on_card_matches_cpu(card, family):
    """One --amp step: bf16 roundings land differently on the two
    devices (cuBLAS and cuDNN against the CPU's kernels), so the loss
    within 1e-2, BN statistics (f32) within 2e-2 of their largest value,
    at most 10 % of the updated parameters more than lr / 100 apart
    (where bf16 noise flips a gradient's sign); on the card the masters
    and Adam's moments stay f32 and the frozen weights come back
    bit-identical."""
    encoder, decoder, imgs, captions, lens = _problem(family)
    lr = 1e-3
    card_run, cpu_run = (train_step_record(
        encoder, decoder, imgs, captions, lens, dev, lr=lr,
        compute_dtype=torch.bfloat16) for dev in (card, "cpu"))
    errs = train_step_errors(card_run, cpu_run, lr)
    assert errs["loss"] <= 1e-2 and errs["step_share_beyond"] <= 0.1, errs
    assert max(errs["bn"].values()) <= 2e-2, errs["bn"]
    for key in ("params", "exp_avg", "exp_avg_sq", "bn"):
        assert all(t.dtype == torch.float32
                   for t in card_run[key].values()), key
    start = dict(encoder.named_parameters(), **dict(
        decoder.named_parameters()))
    for name, value in card_run["frozen"].items():
        assert torch.equal(value, start[name].detach()), name


@pytest.mark.parametrize("family", ["baseline", "attention"])
def test_int8_step_on_card_matches_cpu(card, family):
    """One --int8_encoder step (f32) from the same int8 tree: the int32
    sums and the f32 epilogue are the same on both devices, so the loss
    within rtol 1e-5, and BN statistics unchanged by the step on either
    device."""
    from icd_tpu_torch.models.resnet_int8 import quantize_resnet

    encoder, decoder, imgs, captions, lens = _problem(family)
    qresnet = quantize_resnet(encoder.resnet, calibrate_act_maxes(
        encoder.resnet, imgs, torch.float32))
    card_run, cpu_run = (train_step_record(
        encoder, decoder, imgs, captions, lens, dev, lr=1e-3,
        qresnet=qresnet) for dev in (card, "cpu"))
    errs = train_step_errors(card_run, cpu_run, 1e-3)
    assert errs["loss"] <= 1e-5, errs["loss"]
    start = dict(encoder.named_buffers())
    for run in (card_run, cpu_run):
        for name, value in run["bn"].items():
            assert torch.equal(value, start[name]), name


def test_baseline_and_precision_drivers_run_on_the_card(card, tmp_path,
                                                       monkeypatch):
    """training.baseline.train (two epochs, the head trained) and
    evaluate, and both families' train with --amp and --int8_encoder,
    with no device given, run on the card over in-memory items and
    launch neither K1 nor K2."""
    import argparse

    import icd_tpu_torch.training.attention as ta
    import icd_tpu_torch.training.baseline as tb
    from icd_tpu_torch.checkpoint import load_checkpoint

    monkeypatch.setenv("ICD_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("ICD_TPU_ALLOW_NO_METEOR", "1")
    small = _small_baseline_problem()[0]
    for module in (ta, tb):
        monkeypatch.setattr(module, "COCODataset", _MemoryCaptions)
    monkeypatch.setattr(tb, "init_encoder", lambda gen, size, device:
                        copy.deepcopy(small).to(device))
    monkeypatch.setattr(ta, "init_encoder_attention", lambda gen, device:
                        EncoderAttention(copy.deepcopy(small.resnet)
                                         .to(device)))
    monkeypatch.setattr(ta, "init_attention_decoder", functools.partial(
        init_attention_decoder, encoder_dim=64))

    def args(**kw):
        return argparse.Namespace(**dict(dict(
            model_name="card_b", model="baseline", attention_dim=32,
            decoder_dim=48, decoder_dropout=0.5, embed_size=16, epochs=1,
            batch_size=4, workers=0, encoder_lr=1e-3, decoder_lr=1e-3,
            grad_clip=5.0, alpha_c=1.0, fine_tune_encoder=False,
            fine_tune_embedding=False, checkpoint=None, print_freq=1,
            use_glove=False, max_caption_length=-1, use_bert=False,
            amp=False, int8_encoder=False), **kw))

    fused_attention.launches = beam_search_fused.launches = 0
    encoder, decoder = tb.train(args(epochs=2, fine_tune_encoder=True))
    assert next(decoder.parameters()).device.type == "cuda"
    assert next(encoder.parameters()).device.type == "cuda"
    chkpt = load_checkpoint(name="card_b_1.ckpt")
    adam = adam_moments(chkpt["decoder_optimizer"])
    assert int(adam["count"]) == 4
    assert set(adam["mu"]) == {"encoder", "decoder"}
    metrics = tb.evaluate(args(), chkpt["encoder"], chkpt["decoder"])
    assert len(metrics["losses"]) == 6
    assert all(math.isfinite(v) for v in metrics["losses"])
    for module, name in ((tb, "card_bp"), (ta, "card_ap")):
        module.train(args(model_name=name, amp=True, int8_encoder=True,
                          model="attention" if module is ta else "baseline"))
        losses = load_checkpoint(name=name + "_0.ckpt")["metrics"][
            "epoch_losses"][0]
        assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert (fused_attention.launches, beam_search_fused.launches) == (0, 0)


_NO_CARD = """
import sys
from icd_tpu_torch import eval as port_eval, train as port_train
from icd_tpu_torch.device import resolve_device
from icd_tpu_torch.models.bert import BERT_BASE, init_bert
from icd_tpu_torch.models.bert_embed import BertCaptionEmbedder
from icd_tpu_torch.training import attention, baseline
bert = init_bert(None, dict(BERT_BASE, num_hidden_layers=0, vocab_size=8))
calls = [lambda: port_train.main(["x", "--model", "attention"]),
         lambda: BertCaptionEmbedder(None, model=bert, tokenizer=object()),
         lambda: port_train.main(["x", "--model", "baseline"]),
         lambda: port_eval.main(["x.ckpt", "--model_type", "attention"]),
         lambda: port_eval.main(["x.ckpt", "--model_type", "baseline"])]
for module in (attention, baseline):
    calls += [lambda m=module: m.train(None),
              lambda m=module: m.evaluate(None, None, None)]
for call in calls:
    try:
        call()
    except RuntimeError as err:
        assert "device='cpu'" in str(err), err
    else:
        sys.exit("no error")
print(resolve_device("cpu"))
"""


def test_training_entry_points_raise_with_the_card_hidden(card, tmp_path):
    """With the card hidden (CUDA_VISIBLE_DEVICES empty) the train and
    eval entry points raise unless asked for the CPU; nothing falls back
    to the CPU quietly."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo,
               ICD_TPU_ROOT=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _NO_CARD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "cpu"


def _small_bert(seed=3):
    """A seeded BERT of 2 layers, hidden 64, 4 heads, FFN 128, 100 pieces,
    and 6 seeded rows of 5 to 20 pieces with their word segments."""
    from icd_tpu_torch.models.bert import BERT_BASE, init_bert

    gen = torch.Generator().manual_seed(seed)
    config = dict(BERT_BASE, vocab_size=100, hidden_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, max_position_embeddings=32)
    bert = init_bert(gen, config, "cpu")
    lengths = torch.randint(5, 21, (6,), generator=gen)
    ids = torch.zeros(6, 20, dtype=torch.int64)
    mask = torch.zeros(6, 20, dtype=torch.int64)
    seg = torch.full((6, 20), -1, dtype=torch.int64)
    for i, n in enumerate(lengths.tolist()):
        ids[i, :n] = torch.randint(1, 100, (n,), generator=gen)
        mask[i, :n] = 1
        seg[i, :n] = torch.sort(torch.randint(0, 12, (n,), generator=gen))[0]
    return bert, ids, mask, seg


def test_bert_on_card_matches_cpu(card):
    """BERT's aligned embeddings (f32, TF32 off) on the card and on the
    CPU: within 1e-5 of their largest value (sums in other orders). The
    W8A8 form: its first product sums the same int32s on both devices;
    with the CPU's int8 inputs shared (``SharedQuantization``) every
    product's int32 sums are equal and each product's float input and
    the output are within 1e-5; free-running, the output within 1e-3
    (an activation may round to the other int8 value on the card)."""
    import copy

    from icd_tpu_torch.device import use_exact_f32
    from icd_tpu_torch.models.bert import (bert_aligned_forward,
                                           bert_encoder_forward,
                                           quantize_bert)
    from icd_tpu_torch.ops.qlinear import quantize_rows

    use_exact_f32()
    bert, ids, mask, seg = _small_bert()
    with torch.no_grad():
        want = bert_aligned_forward(bert, ids, mask, seg, 12)
        got = bert_aligned_forward(copy.deepcopy(bert).to(card), ids.to(card),
                                   mask.to(card), seg.to(card), 12).cpu()
    assert got.shape == (6, 12, 64)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    qbert = quantize_bert(bert)
    with torch.no_grad():
        hidden = torch.nn.functional.layer_norm(
            bert.word.weight[ids] + bert.pos.weight[:20] +
            bert.token_type.weight[0], (64,), bert.ln_emb.weight,
            bert.ln_emb.bias, bert.ln_emb.eps).reshape(-1, 64)
    xq, _ = quantize_rows(hidden)
    wq = qbert.layers[0].q.wq
    assert torch.equal(int_mm(xq.to(card), wq.to(card)).cpu(), int_mm(xq, wq))
    shared = SharedQuantization()
    with torch.no_grad():
        qcard = copy.deepcopy(qbert).to(card)
        q_card = bert_encoder_forward(qcard, ids.to(card),
                                      mask.to(card)).cpu()
        with shared.applied():
            q_cpu = bert_encoder_forward(qbert, ids, mask)
        with shared.applied():
            q_shared = bert_encoder_forward(qcard, ids.to(card),
                                            mask.to(card)).cpu()
    assert torch.isfinite(q_card).all()
    valid = mask.bool()
    assert shared.sums_equal and len(shared.records) == 12
    assert shared.input_err <= 1e-5
    assert ((q_shared - q_cpu)[valid].abs().max()
            / q_cpu[valid].abs().max()).item() <= 1e-5
    assert ((q_card - q_cpu)[valid].abs().max()
            / q_cpu[valid].abs().max()).item() <= 1e-3


def test_use_bert_train_step_on_card_matches_cpu(card):
    """One f32 --use_bert step (TF32 off) on seeded unit-scale caption
    embeddings, with the limits of test_train_step_on_card_matches_cpu;
    the decoder's table is bit-identical after the step on both."""
    encoder, decoder, imgs, captions, lens = _small_train_problem()
    emb = torch.randn(4, 13, 16, generator=torch.Generator().manual_seed(5))
    lr = 1e-3
    card_run, cpu_run = (train_step_record(encoder, decoder, imgs, captions,
                                           lens, dev, lr=lr, grad_clip=0.05,
                                           embeddings=emb)
                         for dev in (card, "cpu"))
    for run in (card_run, cpu_run):
        assert torch.equal(run["frozen"]["embedding.weight"],
                           decoder.embedding.weight.detach())
        assert "embedding.weight" not in run["grads"]
    errs = train_step_errors(card_run, cpu_run, lr)
    assert errs["loss"] <= 1e-5 and max(errs["score_bias_grad"]) < 1e-6
    assert max(errs["bn"].values()) <= 1e-5, errs["bn"]
    for key in ("grads", "exp_avg", "exp_avg_sq"):
        assert max(errs[key].values()) <= 1e-2, (key, errs[key])
    assert errs["step_share_beyond"] <= 1e-2
    with torch.no_grad():
        grid, _ = encoder_attention_forward(encoder, imgs, train=True)
    same = [decoder_grads(decoder, grid, captions, lens, dev, embeddings=emb)
            for dev in (card, "cpu")]
    for grads in same:
        assert grads.pop(SCORE_BIAS).abs().max() < 1e-6
    errs = relative_errors(*same)
    assert max(errs.values()) <= 1e-5, errs


# ---------------------------------------------------------------------------
# The multi-chip path on the card
# ---------------------------------------------------------------------------

def _small_trees(family, seed=0):
    """numpy trees of a small model of ``family`` (ResNet (1, 1, 1, 1) of
    widths (4, 8, 8, 16), V = 40) and three batches of 8 images of 64x64
    with seeded captions of 8 tokens."""
    from icd_tpu_torch.params import decoder_to_jax, encoder_to_jax

    gen = torch.Generator().manual_seed(seed)
    resnet = init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    if family == "baseline":
        params = BaselineDecoderParams()
        params.vocab_size, params.embed_size, params.hidden_size = 40, 16, 12
        embed = torch.nn.Linear(64, 16)
        with torch.no_grad():
            for p in embed.parameters():
                p.copy_(torch.rand(p.shape, generator=gen) * 0.25 - 0.125)
        encoder = Encoder(resnet, embed)
        decoder = init_baseline_decoder(gen, params, device="cpu")
    else:
        params = AttentionDecoderParams()
        params.attention_dim, params.decoder_dim = 10, 12
        params.embed_size, params.vocab = 16, range(40)
        encoder = EncoderAttention(resnet)
        decoder = init_attention_decoder(gen, params, encoder_dim=64,
                                         device="cpu")
    batches = [dict(
        imgs=torch.randint(0, 256, (8, 64, 64, 3), generator=gen,
                           dtype=torch.uint8).numpy(),
        captions=seeded_captions(gen, 8, 8, 40, 37, 38,
                                 min_words=1).long().numpy())
        for _ in range(3)]
    return encoder_to_jax(encoder), decoder_to_jax(decoder), batches


@pytest.mark.parametrize("family", ["baseline", "attention"])
def test_one_rank_nccl_mesh_steps_are_bit_equal_to_no_mesh(card, family):
    """Three f32 steps on a (1, 1) mesh of a one-rank NCCL group (every
    collective of the mesh path runs, over one rank) against the same
    steps with no mesh in this process: the mesh path keeps the same
    operations (BN statistics and loss counts are sums divided by the
    count either way), so losses, the updated decoder, Adam's moments
    and the BN statistics are equal to the bit."""
    from icd_tpu_torch.params import decoder_from_jax, encoder_from_jax
    from icd_tpu_torch.parallel import run_ranks
    from icd_tpu_torch.testing import (f32_products, mesh_train,
                                       run_mesh_cases)

    enc, dec, batches = _small_trees(family)
    case = dict(kind="train", name="nccl1", n_data=1, n_model=1,
                family=family, encoder=enc, decoder=dec, batches=batches,
                options=dict(lr=1e-3))
    got = run_ranks(run_mesh_cases, 1, args=([case], "cuda"),
                    backend="nccl", device="cuda:0", limit_s=300)[0]["nccl1"]
    f32_products()
    want = mesh_train(None, family, encoder_from_jax(enc).to(card),
                      decoder_from_jax(dec).to(card), batches, lr=1e-3)
    assert got["losses"] == want["losses"]
    for key in ("decoder", "adam", "bn"):
        got_leaves = _leaves(got[key])
        want_leaves = _leaves(want[key])
        assert got_leaves.keys() == want_leaves.keys()
        for name, value in want_leaves.items():
            assert (got_leaves[name] == value).all(), (key, name)


def _leaves(tree, prefix=()):
    """{path: array} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_leaves(value, prefix + (key,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("family", ["baseline", "attention"])
def test_vocab_parallel_gradients_on_cuda_tensors(card, family):
    """The decoder split over a (1, 2) mesh of two gloo ranks sharing the
    card (CUDA tensors through gloo's all_reduce and list all_gather), a
    loss replicated on both: every gradient, the shards' gathered,
    within 1e-6 of the unsplit decoder's largest value on the card (the
    attention score bias, zero in exact arithmetic, left out)."""
    from icd_tpu_torch.params import decoder_from_jax
    from icd_tpu_torch.parallel import run_ranks
    from icd_tpu_torch.testing import (f32_products, run_mesh_cases,
                                       vocab_grads)

    _, dec, batches = _small_trees(family, seed=1)
    gen = torch.Generator().manual_seed(2)
    inputs = {"captions": batches[0]["captions"]}
    if family == "baseline":
        inputs["feats"] = torch.randn(8, 16, generator=gen).numpy()
    else:
        inputs["grid"] = torch.randn(8, 2, 2, 64, generator=gen).numpy()
    case = dict(kind="vocab_grads", name="vocab", n_data=1, n_model=2,
                family=family, decoder=dec, inputs=inputs)
    got = run_ranks(run_mesh_cases, 2, args=([case], "cuda"),
                    backend="gloo", device="cuda:0", limit_s=300)
    f32_products()
    want = vocab_grads(decoder_from_jax(dec).to(card), family,
                       {k: torch.from_numpy(v).to(card)
                        for k, v in inputs.items()})
    for rank in got:
        assert rank["vocab"]["loss"] == pytest.approx(want["loss"], rel=1e-6)
        got_leaves = _leaves(rank["vocab"]["grads"])
        for name, value in _leaves(want["grads"]).items():
            if name == ("attention", "full_att", "b"):
                continue
            scale = max(float(abs(value).max()), 1e-30)
            err = float(abs(got_leaves[name] - value).max())
            assert err <= 1e-6 * scale, (name, err, scale)


def _cache_batches(gen, n=6, pool=10, b=8):
    """``n`` baseline batches of ``b`` 64x64 images whose ids repeat among
    ``pool`` images, with ``img_ids``."""
    pixels = torch.randint(0, 256, (pool, 64, 64, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    out = []
    for _ in range(n):
        ids = torch.randint(0, pool, (b,), generator=gen).tolist()
        out.append(dict(imgs=pixels[ids], img_ids=ids,
                        captions=seeded_captions(gen, b, 8, 40, 37, 38,
                                                 min_words=1).long().numpy()))
    return out


@pytest.mark.parametrize("budget_rows", [64, 8])
def test_device_image_cache_and_prefetch_on_card_are_bit_equal(card,
                                                               budget_rows):
    """Baseline f32 steps fed three ways on the card: each batch shipped
    by the step, staged by ``device_prefetch`` (a side stream, a producer
    thread), and through the device image cache (``budget_rows`` rows;
    8, one batch, evicts while the producer runs two batches ahead):
    the losses are equal to the bit."""
    from icd_tpu_torch.data.pipeline import DeviceImageCache
    from icd_tpu_torch.params import decoder_from_jax, encoder_from_jax
    from icd_tpu_torch.testing import f32_products
    from icd_tpu_torch.training import baseline
    from icd_tpu_torch.training.common import (make_optimizer,
                                               stage_batches,
                                               trainable_parameters)

    f32_products()
    enc_tree, dec_tree, _ = _small_trees("baseline", seed=3)
    batches = _cache_batches(torch.Generator().manual_seed(4))
    losses = {}
    for way in ("sync", "prefetch", "cache"):
        enc = encoder_from_jax(enc_tree).to(card)
        dec = decoder_from_jax(dec_tree).to(card)
        optimizer = make_optimizer(*trainable_parameters(enc, dec), 1e-3,
                                   1e-3)
        run = baseline.batch_step(baseline.make_train_step(
            enc, dec, optimizer, 0, 5.0), card)
        feed = [dict(b) for b in batches]
        cache = buf = None
        if way == "cache":
            cache = DeviceImageCache(budget_rows * 64 * 64 * 3 / (1 << 30),
                                     (64, 64, 3), 8)
            buf = cache.init_buffer(card)
        else:
            for b in feed:
                b.pop("img_ids")
        if way != "sync":
            feed = stage_batches(feed, card, img_cache=cache, buf=buf)
        losses[way] = torch.stack([run(b) for b in feed]).tolist()
        if cache is not None:
            assert cache.misses > (10 if budget_rows == 8 else 0)
    assert losses["prefetch"] == losses["sync"]
    assert losses["cache"] == losses["sync"]


def test_async_checkpoint_snapshot_on_card(card, tmp_path, monkeypatch):
    """An ``ICD_TPU_CKPT_ASYNC`` save with the writer held back: the
    parameters and Adam's moments on the card are changed in place right
    after the save returns, and the file holds the values at save
    time."""
    import time

    from icd_tpu_torch import checkpoint
    from icd_tpu_torch.params import (adam_state_to_jax, decoder_from_jax,
                                      decoder_to_jax, encoder_from_jax)
    from icd_tpu_torch.training.common import (checkpoint_snapshot,
                                               make_optimizer,
                                               trainable_parameters)

    monkeypatch.setenv("ICD_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("ICD_TPU_CKPT_ASYNC", "1")
    enc_tree, dec_tree, _ = _small_trees("attention", seed=5)
    enc = encoder_from_jax(enc_tree).to(card)
    dec = decoder_from_jax(dec_tree).to(card)
    optimizer = make_optimizer(*trainable_parameters(enc, dec), 1e-3, 1e-3)
    sum(p.sum() for p in dec.parameters() if p.requires_grad).backward()
    optimizer.step()
    want_dec = decoder_to_jax(dec)
    want_mu = adam_state_to_jax(optimizer, dec, enc)["mu"]
    checkpoint._get_async_pool().submit(time.sleep, 0.5)
    args = type("Args", (), dict(model_name="card_async", grad_clip=5.0))()
    checkpoint.save_checkpoint(args, 0, None, None, None, None, {},
                               snapshot=checkpoint_snapshot(enc, dec,
                                                            optimizer))
    with torch.no_grad():
        for p in dec.parameters():
            p.mul_(2.0).add_(1.0)
        for state in optimizer.state.values():
            state["exp_avg"].add_(1.0)
    checkpoint.wait_pending_saves()
    got = checkpoint.load_checkpoint(name="card_async_0.ckpt",
                                     verbose=False)
    got_mu = adam_moments(got["decoder_optimizer"])["mu"]
    for key in ("fc", "h_lin", "f_beta"):
        assert (got["decoder"][key]["w"] == want_dec[key]["w"]).all()
        assert (got_mu["decoder"][key]["w"]
                == want_mu["decoder"][key]["w"]).all()


def test_codec_corpus_decodes_to_pils_digest(card):
    from icd_tpu_torch.native import jpeg
    from icd_tpu_torch.testing import (CODEC_CORPUS_DIGEST, codec_corpus,
                                       pixel_digest)

    corpus = codec_corpus()
    assert pixel_digest([jpeg.decode(data) for _, data in corpus]) == (
        CODEC_CORPUS_DIGEST)


def test_bench_serving_e2e_on_the_card(card, capsys):
    from icd_tpu_torch import bench_serving_e2e

    bench_serving_e2e.main(["--batches", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["e2e_captions_equal_resident"] is True
    assert summary["batches"] == 2 and summary["batch"] == 64
    for key in ("h2d_GB_per_s", "host_images_per_s", "e2e_captions_per_s",
                "device_captions_per_s", "mfu"):
        assert summary[key] > 0, key
    assert summary["card"].startswith("NVIDIA")
    assert len(lines) - 1 == len(bench_serving_e2e.thread_counts(
        os.cpu_count()))
