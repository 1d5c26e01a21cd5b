"""``python -m icd_tpu_torch.bench``'s measuring function on the CPU, at a
small size: a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16), E = H = 16,
V = 53, batch 2 of 64x64 images, 2 repeats, 1 trial, max_len 6, in
both modes; and at that size the six workload benches (``python -m
icd_tpu_torch.bench_*``), with bench_train's GFLOP count and
bench_fused_beam's tokens held against the JAX package. The numbers
they print are CPU numbers and are not checked, only the lines' form
and what each bench promises of its workload."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from icd_tpu_torch import (bench, bench_attention, bench_beam, bench_bert,
                           bench_fused_beam, bench_int8, bench_train)
from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                            init_attention_decoder)
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.encoder import Encoder, EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.utils.benchmarking import result

V = 53
KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "mfu_peak", "card"}


def _small_models():
    gen = torch.Generator().manual_seed(0)
    resnet = init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    embed = torch.nn.Linear(64, 16)
    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size, params.hidden_size = V, 16, 16
    decoder = init_baseline_decoder(gen, params, device="cpu")
    bench.pin_end(decoder, V - 2)
    return Encoder(resnet, embed), decoder


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_bench_measures_on_the_cpu(mode):
    encoder, decoder = _small_models()
    assert decoder.linear.bias[V - 2] == -1e9
    imgs = bench.images(2, 64, device="cpu")
    out = io.StringIO()
    with redirect_stdout(out):
        one, result = bench.measure(encoder, decoder, imgs, mode, repeats=2,
                                    trials=1, decode_len=6, device="cpu")
        print(json.dumps(one))
        print(json.dumps(result))
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(last) == KEYS and last == result
    assert last["value"] > 0 and last["unit"] == "captions/s"
    assert last["card"] == "cpu" and last["mfu"] is None
    assert mode in last["metric"]
    assert last["vs_baseline"] == pytest.approx(last["value"] / 246.0)
    assert one["captions_with_end"] == 0 and one["steps"] == 6
    assert one["int8_decoder"] == (mode == "int8")
    assert one["peak_memory_bytes"] is None
    assert len(one["trial_seconds"]) == 1


def test_bench_rejects_an_unknown_mode():
    """Only bench.py's two modes, each against the H100's dense peak of
    its type (NVIDIA's data sheet)."""
    encoder, decoder = _small_models()
    with pytest.raises(ValueError, match="mode"):
        bench.measure(encoder, decoder, bench.images(2, 64, "cpu"),
                      "fp8", device="cpu")
    assert bench.PEAKS["int8"][0] == 1979e12
    assert bench.PEAKS["bf16"][0] == 989e12


# The six workload benches (python -m icd_tpu_torch.bench_*), each
# driven through its ``measure`` at the size above, against the rows of
# the JAX tool it ports: labels and order as tools/bench_*.py print
# them, a pinned <end> running the whole step budget, and the last
# line's form.

TOOL_LABELS = {
    # tools/bench_int8.py:69-88
    "bench_int8": ["bf16", "int8", "int8+dec"],
    # tools/bench_attention.py:96-97
    "bench_attention": ["bf16", "int8", "int8+dec"],
    # tools/bench_beam.py:68-71
    "bench_beam": ["f32", "bf16", "int8-enc"],
    # tools/bench_fused_beam.py:68-71
    "bench_fused_beam": ["fused", "xla-int8grid", "xla"],
    # tools/bench_train.py:124-126
    "bench_train": ["f32", "amp-bf16", "amp+int8enc"],
    # tools/bench_bert.py's rows that have a counterpart, --decompose's
    # first (:222-229, :337-354), with the W8A8 forward beside the f32
    # one (the int8 BERT of :299-314).
    "bench_bert": ["tokenize+align+pack", "device BERT fwd",
                   "device BERT fwd int8", "device step resident",
                   "inline loop", "overlapped+devBERT",
                   "overlapped+devBERT int8", "overlapped+devBERT --amp",
                   "overlapped+devBERT imgcache steady epoch"],
}
ROW_KEYS = {"label", "ms", "rate", "unit", "per", "k1_launches",
            "k2_launches"}


def _small_attention(embed=16, vocab=None):
    gen = torch.Generator().manual_seed(0)
    resnet = init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    params = AttentionDecoderParams()
    params.attention_dim = params.decoder_dim = 16
    params.embed_size = embed
    params.vocab = range(V) if vocab is None else vocab
    params.use_bert = vocab is not None
    decoder = init_attention_decoder(gen, params, encoder_dim=64,
                                     device="cpu")
    return EncoderAttention(resnet), decoder


def _last_line(tool, rows):
    """The bench's last line as it prints it, read back."""
    out = io.StringIO()
    with redirect_stdout(out):
        print(json.dumps(result(tool, rows, "cpu")))
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(last) == {"tool", "rows", "card"} and last["card"] == "cpu"
    assert [r["label"] for r in last["rows"]] == TOOL_LABELS[tool]
    for r in last["rows"]:
        assert ROW_KEYS <= set(r) and r["ms"] > 0
        assert r["rate"] == pytest.approx(2 * 1e3 / r["ms"])  # batch 2
        assert (r["k1_launches"], r["k2_launches"]) == (0, 0)  # CPU
    return last["rows"]


def test_bench_int8_rows_on_the_cpu():
    encoder, decoder = _small_models()
    rows = _last_line("bench_int8", bench_int8.measure(
        encoder, decoder, bench.images(2, 64, "cpu", seed=2), repeats=2,
        trials=1, decode_len=6, device="cpu"))
    assert [r["steps"] for r in rows] == [6, 6, 6]  # <end> pinned
    assert all(r["unit"] == "captions/s" and r["units"] == 6 for r in rows)


def test_bench_attention_rows_on_the_cpu():
    encoder, decoder = _small_attention()
    bench.pin_end(decoder, V - 2)
    assert decoder.fc.bias[V - 2] == -1e9
    rows = _last_line("bench_attention", bench_attention.measure(
        encoder, decoder, bench.images(2, 64, "cpu", seed=2), repeats=2,
        trials=1, decode_len=6, device="cpu"))
    assert [r["steps"] for r in rows] == [6, 6, 6]


def test_bench_beam_rows_on_the_cpu():
    encoder, decoder = _small_attention()
    bench.pin_end(decoder, V - 2)
    imgs = bench.images(2, 64, "cpu", seed=2)
    rows = _last_line("bench_beam", bench_beam.measure(
        encoder, decoder, imgs, repeats=2, trials=1, max_steps=5,
        device="cpu"))
    assert [r["steps"] for r in rows] == [[5]] * 3
    rows = bench_beam.measure(encoder, decoder, imgs, repeats=1, trials=1,
                              skip_f32=True, max_steps=5, device="cpu")
    assert [r["label"] for r in rows] == ["bf16", "int8-enc"]


def test_bench_fused_beam_rows_on_the_cpu():
    _, decoder = _small_attention()
    bench.pin_end(decoder, V - 2)
    grid = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(2))
    rows = _last_line("bench_fused_beam", bench_fused_beam.measure(
        decoder.to(torch.bfloat16), grid.to(torch.bfloat16), repeats=2,
        trials=1, max_steps=5, device="cpu"))
    assert [r["steps"] for r in rows] == [[5]] * 3
    assert rows[0]["bound_ms"] > 0 and rows[0]["bound_by"] == "bytes"


@pytest.mark.parametrize("attention", [False, True])
def test_bench_train_rows_on_the_cpu(attention):
    encoder, decoder = (_small_attention() if attention
                        else _small_models())
    rows = _last_line("bench_train", bench_train.measure(
        encoder, decoder, bench.images(2, 64, "cpu", seed=2),
        bench_train.captions(2, 6, V, "cpu"), attention, repeats=2,
        trials=1, device="cpu"))
    assert all(r["mfu"] is None and r["unit"] == "images/s"
               and r["per"] == "step" for r in rows)


def test_bench_bert_rows_on_the_cpu():
    from icd_tpu_torch.models.bert import BERT_BASE

    vocab, bert, tokenizer = bench_bert.vocab_and_bert(dict(
        BERT_BASE, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32))
    assert len(vocab) == 2004 and bert.word.weight.shape == (21, 16)
    assert tokenizer.tokenize("w123") == ["w", "##1", "##2", "##3"]
    encoder, decoder = _small_attention(16, vocab)
    batches = bench_bert.host_batches(len(vocab), 2, batch=2, cap_len=6,
                                      size=64)
    rows = _last_line("bench_bert", bench_bert.measure(
        encoder, decoder, bert, tokenizer, vocab, batches, device="cpu"))
    assert all(r["units"] == 2 for r in rows)


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("shape", [{}, dict(e=16, h=16, a=16, v=53, b=2,
                                             t=6)])
def test_bench_train_gflops_equal_the_tools(attention, shape):
    """The model GFLOP count of tools/bench_train.py:36-72, exactly (its
    module imports only numpy at the top)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_train.py")
    spec = importlib.util.spec_from_file_location("tool_bench_train", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert (bench_train.decoder_train_gflops(attention, **shape)
            == tool.decoder_train_gflops(attention, **shape))
    assert (bench_train.BATCH, bench_train.CAP_LEN, bench_train.VOCAB,
            bench_train.REPEATS, bench_train.TRIALS) == (
        tool.BATCH, tool.CAP_LEN, tool.VOCAB, tool.REPEATS, tool.TRIALS)


def test_bench_fused_beam_gives_jax_tokens():
    """bench_fused_beam's workload at tests/test_fused_beam.py:39-59's size
    (b = 4, k = 5, P = 16, V = 40, A = 24, H = 32, E = 16, D = 64, 7
    steps) in f32, <end>'s fc bias at -1e9 as the tool sets it: the
    fused row (K2's plain version on the CPU) and the xla row give JAX
    beam_search_fused's tokens (interpret mode) and beam_search_batched's,
    alphas within 5e-6 (tests/test_torch_fused_beam.py's tolerance). The
    seeded decoder goes to JAX through params.py."""
    import numpy as np

    from icd_tpu.decoding.beam import beam_search_batched as jax_beam
    from icd_tpu.ops.fused_beam import beam_search_fused as jax_fused
    from icd_tpu_torch.params import decoder_to_jax

    v, b, k, p, steps = 40, 4, 5, 16, 7
    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim, params.embed_size = 24, 32, 16
    params.vocab = range(v)
    tdec = init_attention_decoder(torch.Generator().manual_seed(0), params,
                                  encoder_dim=64, device="cpu")
    dec = decoder_to_jax(tdec)
    dec["fc"]["b"][v - 2] = -1e9  # tools/bench_fused_beam.py:41
    bench.pin_end(tdec, v - 2)
    assert np.array_equal(tdec.fc.bias.detach().numpy(), dec["fc"]["b"])
    grids = (np.random.default_rng(10).standard_normal((b, p, 64))
             * 0.5).astype(np.float32)
    refs = [jax_fused(dec, grids, k, v - 3, v - 2, max_steps=steps,
                      chunk_images=2, interpret=True),
            jax_beam(dec, grids, k, v - 3, v - 2, max_steps=steps)]
    for mode in ("fused", "xla"):
        out = bench_fused_beam.search(mode, tdec, torch.from_numpy(grids), k,
                                      v - 3, v - 2, steps)
        assert out["steps"] == steps and not out["found"].any()
        for ref in refs:
            for key in ("seq", "seq_len", "found"):
                np.testing.assert_array_equal(out[key].numpy(),
                                              np.asarray(ref[key]))
            np.testing.assert_allclose(out["alphas"].numpy(),
                                       np.asarray(ref["alphas"]), rtol=0,
                                       atol=5e-6)


@pytest.mark.parametrize("module", [bench_int8, bench_attention, bench_beam,
                                    bench_fused_beam, bench_train,
                                    bench_bert])
def test_benches_raise_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])


# The measuring vocabulary's one home (utils/benchmarking.py): the
# roofline, each kernel's bound through it, the launch account and the
# profiler's device time; and chip_smoke's one launch check. One test
# function: ``--dist loadfile`` deals files to workers in order of
# their test counts, and the JAX package's tests that depend on the
# order (test_cocoeval.py) move when this file's count does.

def _roofline_written_out(nbytes, flops, peak):
    """The roofline as K1's bound computed it before it moved."""
    by_bytes, by_ops = nbytes / 3.35e12, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _check_roofline():
    """Bytes at a tie and where they bound, operations where they do."""
    from icd_tpu_torch.utils.benchmarking import roofline_ms

    for nbytes, flops, peak, bound_by in [
            (64e6, 1e9, 989e12, "bytes"), (1e3, 1e12, 67e12, "operations"),
            (3.35e6, 67e6, 67e12, "bytes"), (0, 1e9, 1979e12, "operations")]:
        got = roofline_ms(nbytes, flops, peak)
        assert got == _roofline_written_out(nbytes, flops, peak)
        assert got[1] == bound_by


def _check_k1_bound(dtype, peak):
    """``ops.fused_attention.bound_ms`` (and the name ``k1_bench`` keeps
    for it): every input and output once at the HBM rate, the products
    at the inputs' type's peak."""
    from icd_tpu_torch import k1_bench
    from icd_tpu_torch.ops.fused_attention import bound_ms

    assert k1_bench.k1_bound_ms is bound_ms
    p, d, a, h = 196, 2048, 512, 512
    for b, k in [(64, 5), (64, 1), (3, 2)]:
        rows, e = b * k, dtype.itemsize
        args = (_meta(b, p, d, dtype=dtype), _meta(b, p, a, dtype=dtype),
                _meta(rows, h, dtype=dtype), _meta(a, h, dtype=dtype),
                _meta(a, dtype=dtype), _meta(a, dtype=dtype),
                _meta(1, dtype=dtype), _meta(d, h, dtype=dtype),
                _meta(d, dtype=dtype))
        out = (_meta(rows, d, dtype=dtype),
               _meta(rows, p, dtype=torch.float32))
        nbytes = ((b * p * d + b * p * a + rows * h + a * h + 2 * a + 1
                   + d * h + d + rows * d) * e + rows * p * 4)
        flops = (2 * rows * h * (a + d) + 4 * rows * p * a
                 + 2 * rows * p * d)
        assert bound_ms(args, out) == _roofline_written_out(nbytes, flops,
                                                            peak)


def _check_k2_bound(dtype, peak):
    from icd_tpu_torch.ops.fused_beam import bound_ms

    b, k, p, d, a, h, e, v = 64, 5, 196, 2048, 512, 512, 512, 10000
    m = lambda *s: _meta(*s, dtype=dtype)  # noqa: E731
    ops = dict(enc=m(b, p, d), att_enc=m(b, p, a), h0=m(b, h), c0=m(b, h),
               emb=m(v, e), wd=m(a, h), bd=m(a), wf=m(a), bf=m(1),
               wg=m(d, h), bg=m(d), wi=m(4 * h, e + d), wh=m(4 * h, h),
               b_sum=_meta(4 * h, dtype=torch.float32), wfc=m(v, h),
               bfc=m(v))
    rows, eb = b * k, dtype.itemsize
    once = ((2 * b * h + a * h + 2 * a + 1 + d * h + d + 4 * h * (e + d)
             + 4 * h * h + v * h + v) * eb + 4 * h * 4)
    for steps in (1, 51):
        nbytes = (steps * ((b * p * d + b * p * a) * eb + rows * p * 4)
                  + once + min(v, rows * steps) * e * eb)
        flops = steps * (2 * rows * h * (a + d) + 4 * rows * p * a
                         + 2 * rows * p * d + 2 * rows * (e + d + h) * 4 * h
                         + 2 * rows * h * v)
        want = _roofline_written_out(nbytes, flops, peak)
        got = bound_ms(ops, k, steps)
        assert got[1] == want[1]
        assert got[0] == pytest.approx(want[0], rel=1e-15)


def _check_epilogue_bounds():
    """K3's and K4's bounds over one batch-64 ResNet-101 forward, as they
    were computed before the HBM rate moved to utils/benchmarking."""
    from icd_tpu_torch import testing
    from icd_tpu_torch.ops import bn_epilogue, int8_epilogue

    assert bn_epilogue.bound_ms(
        testing.bn_epilogue_sites(64)) == 1.4668256668656716
    assert int8_epilogue.bound_ms(
        testing.int8_epilogue_sites(64)) == 1.6656694256716418


def _check_launch_counts():
    """One count for each kernel of ``kernels.KERNELS``; a CPU call of
    each wrapper runs its plain version and counts nothing."""
    from icd_tpu_torch import kernels
    from icd_tpu_torch.models.resnet import bn_terms
    from icd_tpu_torch.ops.bn_epilogue import bn_epilogue
    from icd_tpu_torch.ops.fused_attention import fused_attention
    from icd_tpu_torch.ops.fused_beam import beam_search_fused
    from icd_tpu_torch.ops.int8_epilogue import int8_epilogue
    from icd_tpu_torch.testing import (bn_epilogue_case, int8_epilogue_case,
                                       steered_decoder)
    from icd_tpu_torch.utils.benchmarking import (launch_counts, launches,
                                                  reset_launches)

    reset_launches()
    assert launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    gen = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    fused_attention(n(2, 9, 8), n(2, 9, 6), n(4, 5), n(6, 5), n(6), n(6),
                    n(1), n(8, 5), n(8), rows_per_image=2)
    beam_search_fused(steered_decoder(13, 6, 5, 4, 8, 1, "cpu"), n(2, 9, 8),
                      2, 10, 11, max_steps=3)
    x, bn, cd, r, _ = bn_epilogue_case((2, 3, 3, 8), 1, gen, "f32")
    bn_epilogue(x, bn_terms(bn, cd), r)
    acc, terms, other = int8_epilogue_case((2, 3, 3, 8), 1, True, gen)
    int8_epilogue(acc, terms, other)
    assert launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert launches() == (0, 0)


def _check_device_us():
    from types import SimpleNamespace

    from icd_tpu_torch.utils.benchmarking import device_us

    assert device_us(SimpleNamespace(self_device_time_total=7.5)) == 7.5
    assert device_us(SimpleNamespace(self_cuda_time_total=2.0)) == 2.0
    assert device_us(SimpleNamespace(self_device_time_total=1.0,
                                     self_cuda_time_total=2.0)) == 1.0
    assert device_us(SimpleNamespace()) == 0.0


def _check_expect_launches():
    """chip_smoke's one launch check, with the counts set by hand: every
    kernel recorded under the path, a count given checked, None read."""
    import chip_smoke
    from icd_tpu_torch import kernels
    from icd_tpu_torch.utils.benchmarking import _wrappers, reset_launches

    results = {name: {"launches_by_path": {}} for name in kernels.KERNELS}
    set_to = dict(fused_attention=3, fused_beam=0, bn_epilogue=100,
                  int8_epilogue=7)
    try:
        for name, fn in _wrappers().items():
            fn.launches = set_to[name]
        got = chip_smoke.expect_launches(results, "path", fused_attention=3,
                                         fused_beam=0, bn_epilogue=100,
                                         int8_epilogue=None)
        assert got == set_to
        assert {name: r["launches_by_path"] for name, r in results.items()} \
            == {name: {"path": n} for name, n in set_to.items()}
        with pytest.raises(SystemExit, match="other: bn_epilogue launches"):
            chip_smoke.expect_launches(results, "other", bn_epilogue=0)
        counts = dict(set_to, fused_attention=[1, 2])
        chip_smoke.expect_launches(results, "given", counts)
        assert results["fused_attention"]["launches_by_path"]["given"] == [
            1, 2]
    finally:
        reset_launches()


def test_measuring_vocabulary_and_launch_account():
    """The roofline's choice, K1's and K2's bounds on meta tensors against
    the formulas written out (bf16 and f32), K3's and K4's bounds equal to
    the values they had, the launch account, the profiler's device time
    and chip_smoke's ``expect_launches``."""
    _check_roofline()
    for dtype, peak in [(torch.bfloat16, 989e12), (torch.float32, 67e12)]:
        _check_k1_bound(dtype, peak)
        _check_k2_bound(dtype, peak)
    _check_epilogue_bounds()
    _check_launch_counts()
    _check_device_us()
    _check_expect_launches()
