#!/usr/bin/env python3
"""Drive icd_tpu_torch's beam-search serving path on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each:

1. build       compile every kernel from csrc/ (one nvcc per source, all
               at once) and print the build seconds;
2. k1          K1 (fused attention) against its plain PyTorch version, at
               a ragged shape and at the serving shapes: 64 images x 5
               beams, P=196, D=2048,
               A=H=512. f32: ctx atol 2e-5, alpha atol 2e-6 (the
               tolerances of tests/test_fused_attention.py). bf16: against
               the plain version in f32 on the same bf16-rounded inputs,
               ctx |err| <= 2^-8 |ref| + 1e-5 (bf16 rounding of the output
               is at most 2^-9 relative) and alpha atol 1e-5. Times both
               (CUDA events, L2 flushed before each launch) and prints
               the bound;
3. path_f32    a seeded random-init, full-width encoder (ResNet-101) and
               decoder (V=10,000; BN statistics re-estimated and <end>
               steered, see full_width_models), TF32 off, batch 8, k=5:
               the encoder grid
               against the same encoder on the CPU for one image (max error
               within 1e-3 of the grid's largest value), and the
               beam search through K1 against the one through the plain
               version (equal seq, seq_len, found; alphas atol 5e-6). K1's
               launches equal the decode steps run;
4. serve_bf16  make_beam_captioner at batch 64, 224x224 uint8, k=5, bf16:
               encoder ms, beam ms, steps, K1 launches, captions/s, peak
               memory. Launch counts are zeroed just before this run and
               read just after it;
5. profile     the same beam search once more under torch.profiler: device
               busy time against wall time and the kernels that take it
               (the full table goes to build/profile_beam.txt).

Then one JSON line of every kernel's numbers, the card's name and power
limit as nvidia-smi gives them, and last the line
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, same source
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same source

# Serving shapes: bench.py:36-38 and tools/bench_beam.py:16-20.
IMAGES, BEAMS, PIX, ENC_DIM, ATT_DIM, DEC_DIM = 64, 5, 196, 2048, 512, 512
EMBED, VOCAB = 512, 10000
START_ID, END_ID = VOCAB - 3, VOCAB - 2


def check(ok, what, *values):
    """Fail the run (non-zero exit) unless ``ok``."""
    if not ok:
        raise SystemExit("chip_smoke: check failed: {} {}".format(
            what, values))


def log(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters=20, warmup=3, flush=None):
    """Median ms of ``fn`` on the card, CUDA events around each call;
    ``flush`` (a large tensor) is zeroed before each call to empty L2."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def k1_inputs(gen, dtype, device):
    """K1's arguments at the serving shapes, weights at 1/sqrt(fan_in)."""
    import torch

    rows = IMAGES * BEAMS

    def n(*shape, scale=1.0):
        t = torch.randn(shape, generator=gen) * scale
        return t.to(device=device, dtype=dtype)

    s = DEC_DIM ** -0.5
    return (n(IMAGES, PIX, ENC_DIM), n(IMAGES, PIX, ATT_DIM),
            n(rows, DEC_DIM), n(ATT_DIM, DEC_DIM, scale=s),
            n(ATT_DIM, scale=s),
            n(ATT_DIM, scale=ATT_DIM ** -0.5), n(1, scale=0.1),
            n(ENC_DIM, DEC_DIM, scale=s), n(ENC_DIM, scale=s))


def k1_bound_ms(args, out):
    """Least time for K1's work on an H100: each input read once, each
    output written once, at 3.35 TB/s; its operations at the bf16 peak."""
    enc, att_enc, h = args[0], args[1], args[2]
    rows, hd = h.shape
    b, p, d = enc.shape
    a = att_enc.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *out))
    flops = (2 * rows * hd * (a + d)  # the two products of h
             + 4 * rows * p * a  # add, relu, multiply-add per score term
             + 2 * rows * p * d)  # context sum
    peak = BF16_FLOP_PER_S if enc.element_size() == 2 else F32_FLOP_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def phase_build():
    from icd_tpu_torch import kernels

    t0 = time.time()
    reports = kernels.build_all()
    seconds = time.time() - t0
    for name, (path, ptxas) in reports.items():
        print("ptxas {}:\n{}".format(name, ptxas), file=sys.stderr)
    log("build", seconds=round(seconds, 3), kernels=sorted(reports))


def phase_k1(results):
    import torch

    from icd_tpu_torch.ops.fused_attention import (fused_attention,
                                                   fused_attention_reference)

    gen = torch.Generator().manual_seed(1)
    # A ragged shape first: one row per image, no dimension a multiple
    # of a tile.
    odd = [torch.randn(s, generator=gen).cuda() * 0.3 for s in (
        (3, 100, 200), (3, 100, 72), (3, 40), (72, 40), (72,), (72,), (1,),
        (200, 40), (200,))]
    ctx, alpha = fused_attention(*odd)
    ref_ctx, ref_alpha = fused_attention_reference(*odd)
    torch.cuda.synchronize()
    err = (ctx - ref_ctx).abs().max().item()
    check(err <= 2e-5, "ragged f32 ctx error", err)
    err = (alpha - ref_alpha).abs().max().item()
    check(err <= 2e-6, "ragged f32 alpha error", err)

    args32 = k1_inputs(gen, torch.float32, "cuda")
    kw = dict(rows_per_image=BEAMS)
    ctx, alpha = fused_attention(*args32, **kw)
    ref_ctx, ref_alpha = fused_attention_reference(*args32, **kw)
    torch.cuda.synchronize()
    f32_ctx_err = (ctx - ref_ctx).abs().max().item()
    f32_alpha_err = (alpha - ref_alpha).abs().max().item()
    check(f32_ctx_err <= 2e-5, "f32 ctx error", f32_ctx_err)
    check(f32_alpha_err <= 2e-6, "f32 alpha error", f32_alpha_err)

    args16 = tuple(t.to(torch.bfloat16) for t in args32)
    ctx, alpha = fused_attention(*args16, **kw)
    ref_ctx, ref_alpha = fused_attention_reference(
        *(t.float() for t in args16), **kw)
    torch.cuda.synchronize()
    check(ctx.dtype == torch.bfloat16 and alpha.dtype == torch.float32,
          "K1 output dtypes", ctx.dtype, alpha.dtype)
    err = (ctx.float() - ref_ctx).abs()
    check(bool((err <= 2 ** -8 * ref_ctx.abs() + 1e-5).all()),
          "bf16 ctx error", err.max().item())
    bf16_ctx_err = err.max().item()
    bf16_alpha_err = (alpha - ref_alpha).abs().max().item()
    check(bf16_alpha_err <= 1e-5, "bf16 alpha error", bf16_alpha_err)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    kernel_ms = time_ms(lambda: fused_attention(*args16, **kw), flush=flush)
    plain_ms = time_ms(lambda: fused_attention_reference(*args16, **kw),
                       flush=flush)
    bound_ms, bound_by = k1_bound_ms(args16, (ctx, alpha))
    results["fused_attention"] = dict(
        max_abs_err=bf16_ctx_err, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    log("k1", shapes=dict(images=IMAGES, rows_per_image=BEAMS, P=PIX,
                          D=ENC_DIM, A=ATT_DIM, H=DEC_DIM),
        f32_ctx_err=f32_ctx_err, f32_alpha_err=f32_alpha_err,
        bf16_ctx_err=bf16_ctx_err, bf16_alpha_err=bf16_alpha_err,
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / kernel_ms)


def calibrate_bn(encoder, imgs):
    """Set every BN's running statistics to those of its input on
    ``imgs``, layer by layer. A random He-init ResNet-101 with identity
    BN doubles its activations' variance at each residual block (grids
    near 1e7); re-estimated statistics keep them at the scale a trained
    encoder has."""
    import torch

    import icd_tpu_torch.models.resnet as resnet
    from icd_tpu_torch.models.encoder import encoder_attention_forward

    plain = resnet.batch_norm

    def estimating(x, bn, compute_dtype=None):
        xf = x.float().reshape(-1, x.shape[-1])
        bn.mean.copy_(xf.mean(0))
        bn.var.copy_(xf.var(0))
        return plain(x, bn, compute_dtype)

    resnet.batch_norm = estimating
    try:
        with torch.no_grad():
            encoder_attention_forward(encoder, imgs.to("cuda"))
    finally:
        resnet.batch_norm = plain


def steer_end(decoder, end_id, rate=0.05, spread=0.1, threshold=20.0,
              unit=0):
    """Give a random decoder captions of image-dependent length: LSTM
    unit ``unit`` counts steps (i, f, o gates open, c from 0, g = tanh(
    atanh(rate) + spread * ctx . w) with w a zero-mean unit vector) and is
    the only input of the <end> logit, 40 * h_unit - threshold. A random
    decoder left as it is never emits <end> among 10,000 near-equal
    logits."""
    import math

    import torch

    hd = decoder.lstm.hidden_size
    emb = decoder.embedding.embedding_dim
    i, f, g, o = (gate * hd + unit for gate in range(4))
    lstm = decoder.lstm
    with torch.no_grad():
        lstm.weight_ih[[i, f, o]] = 0.0
        lstm.weight_hh[[i, f, g, o]] = 0.0
        lstm.bias_ih[[i, f, o]] = 10.0
        lstm.bias_hh[[i, f, g, o]] = 0.0
        w = lstm.weight_ih[g, emb:]
        w = w - w.mean()  # blind to the grid's common offset
        lstm.weight_ih[g, emb:] = spread * w / w.norm()
        lstm.weight_ih[g, :emb] = 0.0
        lstm.bias_ih[g] = math.atanh(rate)
        decoder.c_lin.weight[unit] = 0.0
        decoder.c_lin.bias[unit] = 0.0
        decoder.fc.weight[end_id] = 0.0
        decoder.fc.weight[end_id, unit] = 40.0
        decoder.fc.bias[end_id] = -threshold


def full_width_models():
    """ResNet-101 encoder (BN statistics re-estimated on random images)
    and a V=10,000 decoder (steered to finish captions), from one seeded
    generator, f32, on the card."""
    import torch

    from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                                init_attention_decoder)
    from icd_tpu_torch.models.encoder import init_encoder_attention

    gen = torch.Generator().manual_seed(0)
    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim = ATT_DIM, DEC_DIM
    params.embed_size, params.vocab = EMBED, range(VOCAB)
    encoder = init_encoder_attention(gen, device="cuda")
    decoder = init_attention_decoder(gen, params, device="cuda")
    calibrate_bn(encoder, uint8_images(16, seed=1))
    steer_end(decoder, END_ID)
    return encoder, decoder


def uint8_images(n, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 224, 224, 3), generator=gen,
                         dtype=torch.uint8)


@contextlib.contextmanager
def plain_attention():
    """decode_step through K1's plain version, for the comparison run."""
    import icd_tpu_torch.models.attention as attention
    from icd_tpu_torch.ops.fused_attention import fused_attention_reference

    kernel = attention.fused_attention
    attention.fused_attention = fused_attention_reference
    try:
        yield
    finally:
        attention.fused_attention = kernel


def phase_path_f32(models):
    import torch

    from icd_tpu_torch.decoding.serve import make_beam_captioner
    from icd_tpu_torch.models.encoder import encoder_attention_forward
    from icd_tpu_torch.ops.fused_attention import fused_attention

    encoder, decoder = models
    captioner = make_beam_captioner(encoder, decoder, START_ID, END_ID,
                                    beam_size=BEAMS,
                                    compute_dtype=torch.float32,
                                    device="cuda")
    check(not torch.backends.cudnn.allow_tf32, "TF32 off for f32")
    imgs = uint8_images(8, seed=2)
    grid = captioner.encode(imgs)
    with torch.inference_mode():
        cpu_grid = encoder_attention_forward(copy.deepcopy(encoder).cpu(),
                                             imgs[:1])
    grid_err = (grid[:1].cpu() - cpu_grid).abs().max().item()
    grid_scale = cpu_grid.abs().max().item()
    check(grid.shape == (8, 14, 14, ENC_DIM), "f32 grid shape", grid.shape)
    # f32 on both sides, different convolution algorithms: ~1e-6 of the
    # grid's scale with identity BN, up to ~1e-3 once re-estimated BN
    # divides channels of tiny variance (TF32 would give ~1e-2).
    check(grid_err <= 1e-3 * grid_scale, "f32 grid vs CPU", grid_err,
          grid_scale)

    fused_attention.launches = 0
    out = captioner.decode(grid)
    torch.cuda.synchronize()
    launches = fused_attention.launches
    check(launches == out["steps"], "K1 launches vs steps", launches,
          out["steps"])
    with plain_attention():
        ref = captioner.decode(grid)
    check(fused_attention.launches == launches, "K1 launched by plain run")
    for key in ("seq", "seq_len", "found"):
        check(torch.equal(out[key], ref[key]), "kernel vs plain", key)
    alpha_err = (out["alphas"] - ref["alphas"]).abs().max().item()
    check(alpha_err <= 5e-6, "kernel vs plain alphas", alpha_err)
    log("path_f32", images=8, beams=BEAMS, vocab=VOCAB, steps=out["steps"],
        k1_launches=launches, grid_err_vs_cpu=grid_err, grid_max=grid_scale,
        alpha_err_vs_plain=alpha_err,
        found=int(out["found"].sum()), seq_len=out["seq_len"].tolist())


def phase_serve_bf16(models, results):
    import torch

    from icd_tpu_torch.decoding.serve import make_beam_captioner
    from icd_tpu_torch.ops.fused_attention import fused_attention

    encoder, decoder = models
    captioner = make_beam_captioner(encoder, decoder, START_ID, END_ID,
                                    beam_size=BEAMS,
                                    compute_dtype=torch.bfloat16,
                                    device="cuda")
    imgs = uint8_images(IMAGES, seed=3).cuda()
    captioner(imgs)  # warm-up: kernel load, cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_attention.launches = 0
    t0 = time.perf_counter()
    grid = captioner.encode(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = captioner.decode(grid)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = fused_attention.launches
    peak = torch.cuda.max_memory_allocated()

    check(launches > 0 and launches == out["steps"], "K1 launches vs steps",
          launches, out["steps"])
    check(grid.shape == (IMAGES, 14, 14, ENC_DIM), "grid shape", grid.shape)
    check(grid.dtype == torch.bfloat16 and bool(grid.isfinite().all()),
          "bf16 finite grid")
    check(out["seq"].shape == (IMAGES, 52), "seq shape", out["seq"].shape)
    check(bool((out["seq"][:, 0] == START_ID).all()), "seq starts with start")
    lens = out["seq_len"]
    check(bool(((lens >= 2) & (lens <= 52)).all()), "seq_len range")
    check(bool(out["alphas"].isfinite().all()), "finite alphas")
    results["fused_attention"]["launches"] = launches
    log("serve_bf16", images=IMAGES, beams=BEAMS, vocab=VOCAB,
        encoder_ms=(t1 - t0) * 1e3, beam_ms=(t2 - t1) * 1e3,
        steps=out["steps"], k1_launches=launches,
        captions_per_s=IMAGES / (t2 - t0), peak_memory_bytes=peak,
        found=int(out["found"].sum()), seq_len=out["seq_len"].tolist())
    return captioner, grid


def phase_profile(captioner, grid):
    """One beam search of the serving batch under torch.profiler: device
    busy time against wall time, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = captioner.decode(grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    kernels = sorted(((device_us(e), e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_beam.txt"), "w") as f:
        for us, count, name in kernels:
            f.write("{:12.1f} us {:6d}x  {}\n".format(us, count, name))
    log("profile", steps=out["steps"], wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
        top=[dict(name=name[:60], ms=us / 1e3, count=count)
             for us, count, name in kernels[:10]])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import icd_tpu_torch.kernels  # noqa: F401  (fails outside the repo)

    print(card_line(), flush=True)
    results = {}
    phase_build()
    phase_k1(results)
    models = full_width_models()
    phase_path_f32(models)
    phase_profile(*phase_serve_bf16(models, results))

    k1 = dict(name="fused_attention", route="cuda",
              source="icd_tpu_torch/csrc/fused_attention.cu",
              replaces="icd_tpu/ops/fused_attention.py:45",
              library_ms=None, **results["fused_attention"])
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
