#!/usr/bin/env python3
"""Drive icd_tpu_torch's beam-search serving paths on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each:

1. build       compile every kernel from csrc/ (one nvcc per source, all
               at once) and print the build seconds; then k1_ptxas and
               k2_ptxas, registers and spill bytes of each bf16 kernel
               entry of K1 (its gate and attention kernels) and of K2,
               which must show no spills;
2. k1          K1 (fused attention) against its plain PyTorch version, at
               a ragged shape and at the serving shapes: 64 images x 5
               beams, P=196, D=2048,
               A=H=512. f32: ctx atol 2e-5, alpha atol 2e-6 (the
               tolerances of tests/test_fused_attention.py). bf16: against
               the plain version in f32 on the same bf16-rounded inputs,
               ctx |err| <= 2^-8 |ref| + 1e-5 (bf16 rounding of the output
               is at most 2^-9 relative) and alpha atol 1e-5. Times both
               (CUDA events, L2 flushed before each launch, the card
               asleep while the host sets it up) and prints the bound;
               then k1_phases, K1's own clock on one bf16 launch: the
               median over blocks of each phase (gate; att_dec, scores,
               context, combine, store) and the span from the first
               block's start to the last block's end, which must account
               for the CUDA events' time of the same launch within 10 %;
3. path_f32    a seeded random-init, full-width encoder (ResNet-101) and
               decoder (V=10,000; BN statistics re-estimated and <end>
               steered, see full_width_models), TF32 off, batch 8, k=5:
               the encoder grid
               against the same encoder on the CPU for one image (max error
               within 1e-3 of the grid's largest value), and the
               beam search through K1 against the one through the plain
               version (equal seq, seq_len, found; alphas atol 5e-6). K1's
               launches equal the decode steps run;
4. k2          K2 (the whole beam search in one launch) against its plain
               version in f32, TF32 off: at a ragged shape (3 images x 3
               beams, P=49, V=997, 9 steps), on path_f32's full-width
               grid and on the f32 grid of serve_bf16's 64 images (320
               rows: five row tiles). seq, seq_len and found equal, alphas
               atol 5e-6 (sums in another order), and the same tokens as
               the per-step search through K1; one launch per call;
5. serve_bf16  make_beam_captioner at batch 64, 224x224 uint8, k=5, bf16:
               encoder ms, beam ms, steps, K1 launches, captions/s, peak
               memory. Launch counts are zeroed just before this run and
               read just after it;
6. profile     the same beam search once more under torch.profiler: device
               busy time against wall time and the kernels that take it
               (the full table goes to build/profile_beam.txt);
7. serve_fused_bf16  the same serving batch with beam_fn=beam_search_fused:
               encoder ms, beam ms, steps, K2 launches (1), captions/s, peak
               memory; K2's own ms (CUDA events; the card sleeps while the
               host sets each launch up) against its bound and its
               plain version's ms; then k2_phases, K2's own clock (one
               read after each grid barrier) as us per phase summed over
               the steps and per step, which must account for the CUDA
               events' time of the same launch within 10 %; and how many
               of the 64 captions equal
               the plain version's on the same bf16 grid: at least 60, or
               as many as the plain version on the card has equal to
               itself on the CPU if that is fewer (bf16 logits make this
               random decoder's near-tie beams split when sums run in
               another order). Then K2's bf16 rounding points at all 320
               rows: step 1's raw alphas within atol 1e-6 of the plain
               version's, and at least 60 of 64 captions equal to it on a
               seeded N(0, 1) bf16 grid;
8. beam_eval   icd_tpu_torch.beam_eval.caption_images with the fused
               captioner over 130 seeded uint8 images at batch 64 (three
               batches, the last padded): 130 results, seconds per caption;
9. profile_fused  one fused beam search under torch.profiler (table in
               build/profile_fused_beam.txt).

Then one JSON line of every kernel's numbers (K2's with its per-phase
ms), the card's name and power limit as nvidia-smi gives them, and last
the line
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
"""

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time

# Serving shapes: bench.py:36-38 and tools/bench_beam.py:16-20.
IMAGES, BEAMS, PIX, ENC_DIM, ATT_DIM, DEC_DIM = 64, 5, 196, 2048, 512, 512
EMBED, VOCAB = 512, 10000
START_ID, END_ID = VOCAB - 3, VOCAB - 2
SETTLE_CYCLES = 100_000_000  # about 50 ms of the card's clock


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


def k2_bound_ms(ops, k, steps):
    """Least time for one K2 search of ``steps`` steps on an H100: enc and
    att_enc read once a step (no chip memory holds them at batch 64), the
    weights, h0 and c0 read once, of the embedding only the rows gathered
    (one a beam a step, at most the whole table), the raw alphas written
    once; the step's products at the peak of the grid's dtype."""
    from icd_tpu_torch import k1_bench

    enc, att_enc, emb = ops["enc"], ops["att_enc"], ops["emb"]
    b, p, d = enc.shape
    a, hd = ops["wd"].shape
    v, e = emb.shape
    rows = b * k
    per_step = sum(t.numel() * t.element_size() for t in (enc, att_enc))
    once = sum(t.numel() * t.element_size() for name, t in ops.items()
               if name not in ("enc", "att_enc", "emb"))
    gathered = min(v, rows * steps) * e * emb.element_size()
    nbytes = steps * (per_step + rows * p * 4) + once + gathered
    flops = steps * (2 * rows * hd * (a + d)  # att_dec and gate
                     + 4 * rows * p * a  # scores
                     + 2 * rows * p * d  # context
                     + 2 * rows * (e + d + hd) * 4 * hd  # LSTM gates
                     + 2 * rows * hd * v)  # fc
    peak = (k1_bench.BF16_FLOP_PER_S if enc.element_size() == 2
            else k1_bench.F32_FLOP_PER_S)
    by_bytes, by_ops = nbytes / k1_bench.HBM_BYTES_PER_S, flops / peak
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
    ptxas_line("k1_ptxas", reports["fused_attention"][1],
               ("k1_gate", "k1_attention"))
    ptxas_line("k2_ptxas", reports["fused_beam"][1], ("fused_beam",))


def ptxas_line(phase, report, kernels):
    """ptxas's report for the bf16 entry functions whose names hold one
    of ``kernels``: registers and spill bytes of each; fails on any
    spill."""
    entries = []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            keep = ("nv_bfloat16" in name
                    and any(k in name for k in kernels))
            entries.append(dict(entry=name) if keep else None)
        elif entries and entries[-1] is not None:
            spills = re.findall(r"(\d+) bytes spill", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spills:
                entries[-1]["spill_bytes"] = sum(int(n) for n in spills)
            if regs:
                entries[-1]["registers"] = int(regs.group(1))
    if not report:
        log(phase, report="not built in this run (library cached)")
        return
    entries = [e for e in entries if e is not None]
    check(entries and all("spill_bytes" in e for e in entries),
          "ptxas report of " + phase, entries)
    spilled = sum(e["spill_bytes"] for e in entries)
    check(spilled == 0, phase + ": bf16 kernel spills registers", entries)
    log(phase, report=entries, spill_bytes=spilled)


def phase_k1(results):
    import torch

    from icd_tpu_torch.k1_bench import k1_bound_ms, k1_inputs, time_ms

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
    kernel_ms = time_ms(lambda: fused_attention(*args16, **kw), flush=flush,
                        settle=True)
    plain_ms = time_ms(lambda: fused_attention_reference(*args16, **kw),
                       flush=flush, settle=True)
    bound_ms, bound_by = k1_bound_ms(args16, (ctx, alpha))
    results["fused_attention"] = dict(
        max_abs_err=bf16_ctx_err, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        phase_us=k1_phases(args16, flush))
    log("k1", shapes=dict(images=IMAGES, rows_per_image=BEAMS, P=PIX,
                          D=ENC_DIM, A=ATT_DIM, H=DEC_DIM),
        f32_ctx_err=f32_ctx_err, f32_alpha_err=f32_alpha_err,
        bf16_ctx_err=bf16_ctx_err, bf16_alpha_err=bf16_alpha_err,
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / kernel_ms)


def k1_phases(args, flush):
    """One bf16 K1 launch at the serving shapes, L2 emptied before it:
    its own clock (median us of each phase over blocks, and the span
    from the first block's start to the last block's end) against CUDA
    events around the same launch. The span must account for the
    launch within 10 %."""
    import torch

    from icd_tpu_torch.ops.fused_attention import _launch, phase_us

    flush.zero_()
    # The card sleeps while the host sets the launch up, so the events
    # time the launch and nothing of the host.
    torch.cuda._sleep(SETTLE_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, _, clock = _launch(*args, BEAMS)
    end.record()
    end.synchronize()
    event_us = start.elapsed_time(end) * 1e3
    for stamps in clock.values():
        check(bool((stamps.diff(dim=1) >= 0).all()), "K1 clock runs forward")
    us = phase_us(clock)
    check(abs(us["span"] - event_us) <= 0.1 * event_us,
          "K1 clock vs CUDA events", us["span"], event_us)
    log("k1_phases", event_us=event_us, span_us=us["span"],
        median_us={name: v for name, v in us.items() if name != "span"})
    return us


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


def full_width_models():
    """ResNet-101 encoder (BN statistics re-estimated on random images)
    and a V=10,000 decoder (steered to finish captions), from one seeded
    generator, f32, on the card."""
    import torch

    from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                                init_attention_decoder)
    from icd_tpu_torch.models.encoder import init_encoder_attention
    from icd_tpu_torch.testing import steer_end

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
    return captioner, grid, out


def k2_against_plain(decoder, grid, k, start_id, end_id, max_steps, what):
    """K2 vs its plain version and vs the per-step search through K1, in
    f32: equal tokens, alphas atol 5e-6. Returns (K2's dict, alpha error
    vs plain, alpha error vs the per-step search)."""
    import torch

    from icd_tpu_torch.decoding.beam import beam_search_batched
    from icd_tpu_torch.ops.fused_beam import (beam_search_fused,
                                              beam_search_fused_reference)

    before = beam_search_fused.launches
    out = beam_search_fused(decoder, grid, k, start_id, end_id, max_steps)
    torch.cuda.synchronize()
    check(beam_search_fused.launches == before + 1, what + " K2 launches",
          beam_search_fused.launches - before)
    ref = beam_search_fused_reference(decoder, grid, k, start_id, end_id,
                                      max_steps)
    loop = beam_search_batched(decoder, grid, k, start_id, end_id,
                               max_steps)
    check(beam_search_fused.launches == before + 1,
          what + " K2 launched by the other runs")
    for key in ("seq", "seq_len", "found"):
        check(torch.equal(out[key], ref[key]), what + " K2 vs plain", key)
        check(torch.equal(out[key], loop[key]), what + " K2 vs K1 loop", key)
    check(out["steps"] == ref["steps"] == loop["steps"], what + " steps",
          out["steps"], ref["steps"], loop["steps"])
    err = (out["alphas"] - ref["alphas"]).abs().max().item()
    check(err <= 5e-6, what + " K2 vs plain alphas", err)
    loop_err = (out["alphas"] - loop["alphas"]).abs().max().item()
    return out, err, loop_err


def phase_k2(path_f32, results):
    import torch

    from icd_tpu_torch.ops.fused_beam import beam_search_fused
    from icd_tpu_torch.testing import steered_decoder

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 off for f32")
    vocab = 997  # a ragged shape: no size a multiple of a tile
    decoder = steered_decoder(vocab, 40, 48, 24, 200, seed=4, device="cuda")
    grid = torch.randn(3, 49, 200,
                       generator=torch.Generator().manual_seed(5)).cuda()
    small, small_err, _ = k2_against_plain(decoder, grid, 3, vocab - 3,
                                           vocab - 2, 9, "ragged")
    check(bool(small["found"].any()), "ragged: a caption completes")

    captioner, grid, _ = path_f32
    out, err, loop_err = k2_against_plain(captioner.decoder, grid, BEAMS,
                                          START_ID, END_ID, 51, "f32")
    # The serving batch in f32: 320 rows, five row tiles of each product.
    grid64 = captioner.encode(uint8_images(IMAGES, seed=3))
    out64, err64, loop_err64 = k2_against_plain(
        captioner.decoder, grid64, BEAMS, START_ID, END_ID, 51, "f32 b64")
    results["fused_beam"] = dict(max_abs_err=max(err, err64))
    log("k2", ragged=dict(images=3, beams=3, P=49, V=vocab, max_steps=9,
                          steps=small["steps"], alpha_err_vs_plain=small_err,
                          seq_len=small["seq_len"].tolist()),
        images=8, beams=BEAMS, vocab=VOCAB, steps=out["steps"],
        alpha_err_vs_plain=err, alpha_err_vs_k1_loop=loop_err,
        grid_blocks=beam_search_fused.grid_blocks,
        found=int(out["found"].sum()), seq_len=out["seq_len"].tolist(),
        batch64=dict(steps=out64["steps"], alpha_err_vs_plain=err64,
                     alpha_err_vs_k1_loop=loop_err64,
                     found=int(out64["found"].sum())))


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


def phase_profile(captioner, grid, phase="profile",
                  table="profile_beam.txt"):
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
    with open(os.path.join(out_dir, table), "w") as f:
        for us, count, name in kernels:
            f.write("{:12.1f} us {:6d}x  {}\n".format(us, count, name))
    log(phase, steps=out["steps"], wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
        top=[dict(name=name[:60], ms=us / 1e3, count=count)
             for us, count, name in kernels[:10]])


def phase_serve_fused_bf16(models, results):
    import torch

    from icd_tpu_torch.decoding.serve import make_beam_captioner
    from icd_tpu_torch.k1_bench import time_ms
    from icd_tpu_torch.ops import fused_beam
    from icd_tpu_torch.ops.fused_attention import fused_attention

    encoder, decoder = models
    captioner = make_beam_captioner(encoder, decoder, START_ID, END_ID,
                                    beam_size=BEAMS,
                                    compute_dtype=torch.bfloat16,
                                    device="cuda",
                                    beam_fn=fused_beam.beam_search_fused)
    imgs = uint8_images(IMAGES, seed=3).cuda()
    captioner(imgs)  # warm-up: kernel load, cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_attention.launches = 0
    fused_beam.beam_search_fused.launches = 0
    t0 = time.perf_counter()
    grid = captioner.encode(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = captioner.decode(grid)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = fused_beam.beam_search_fused.launches
    k1_launches = fused_attention.launches
    peak = torch.cuda.max_memory_allocated()

    check(launches == 1, "K2 launches per batch", launches)
    check(k1_launches == 0, "K1 launched by the fused path", k1_launches)
    check(out["seq"].shape == (IMAGES, 52), "seq shape", out["seq"].shape)
    check(bool((out["seq"][:, 0] == START_ID).all()), "seq starts with start")
    lens = out["seq_len"]
    check(bool(((lens >= 2) & (lens <= 52)).all()), "seq_len range")
    check(bool(out["alphas"].isfinite().all()), "finite alphas")

    # K2 alone, and its plain version, on the same operands. The
    # yardstick for bf16 agreement is the plain version against itself
    # with its sums in another order (on the CPU): bf16 logits make this
    # random decoder's near-tie beams split there too.
    steps = out["steps"]
    search = (BEAMS, START_ID, END_ID, 51)
    with torch.inference_mode():
        ops = fused_beam._operands(captioner.decoder, grid)
    plain = fused_beam._outputs(fused_beam._search_plain(ops, *search),
                                START_ID, END_ID)
    plain_cpu = fused_beam._outputs(fused_beam._search_plain(
        {name: t.cpu() for name, t in ops.items()}, *search),
        START_ID, END_ID)

    def same_captions(a, b):
        return int((a["seq"].cpu() == b["seq"].cpu()).all(dim=1).sum())

    same = same_captions(out, plain)
    yardstick = same_captions(plain, plain_cpu)
    check(same >= min(60, yardstick), "bf16 captions equal to the plain "
          "version", same, "plain on the card vs on the CPU", yardstick)
    # K2's bf16 rounding points at all 320 rows, on inputs where sums in
    # another order cannot reorder beams: step 1's raw alphas (att_dec
    # stays f32; rounded to bf16 it would move them by ~5e-6), and 60 of
    # 64 captions on a seeded N(0, 1) grid, whose beams have no dense
    # bf16 ties.
    first = fused_beam._launch(ops, BEAMS, START_ID, END_ID, 1)
    first_ref = fused_beam._search_plain(ops, BEAMS, START_ID, END_ID, 1)
    step1_alpha_err = (first["alpha"][1] - first_ref["alpha"][1]).abs().max(
        ).item()
    check(step1_alpha_err <= 1e-6, "bf16 step-1 alphas vs plain",
          step1_alpha_err)
    rand = torch.randn(grid.shape, generator=torch.Generator().manual_seed(
        7)).to("cuda", torch.bfloat16)
    same_rand = same_captions(
        fused_beam.beam_search_fused(captioner.decoder, rand, *search),
        fused_beam.beam_search_fused_reference(captioner.decoder, rand,
                                               *search))
    check(same_rand >= 60, "bf16 captions equal to the plain version on a "
          "random grid", same_rand)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    # _start launches without reading the step count back, so nothing
    # waits on the host between the events.
    kernel_ms = time_ms(lambda: fused_beam._start(ops, *search), iters=10,
                        flush=flush, settle=True)
    plain_ms = time_ms(lambda: fused_beam._search_plain(ops, *search),
                       iters=3, warmup=1, flush=flush)
    bound_ms, bound_by = k2_bound_ms(ops, BEAMS, steps)
    phases = k2_phases(ops, search, flush)
    results["fused_beam"].update(launches=launches, ms=kernel_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, phase_ms=phases)
    log("serve_fused_bf16", images=IMAGES, beams=BEAMS, vocab=VOCAB,
        encoder_ms=(t1 - t0) * 1e3, beam_ms=(t2 - t1) * 1e3, steps=steps,
        k2_launches=launches, captions_per_s=IMAGES / (t2 - t0),
        peak_memory_bytes=peak, k2_ms=kernel_ms, k2_plain_ms=plain_ms,
        k2_bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / kernel_ms,
        grid_blocks=fused_beam.beam_search_fused.grid_blocks,
        same_captions_as_plain=same,
        same_captions_plain_card_vs_cpu=yardstick,
        same_captions_as_plain_cpu=same_captions(out, plain_cpu),
        step1_alpha_err_vs_plain=step1_alpha_err,
        same_captions_as_plain_random_grid=same_rand,
        found=int(out["found"].sum()),
        seq_len=out["seq_len"].tolist())
    return captioner, grid


def k2_phases(ops, search, flush):
    """One K2 launch on the serving operands, L2 emptied before it: its
    own clock's time per phase (summed over the steps and per step, in
    us) against CUDA events around the same launch. The clock must
    account for the launch within 10 %."""
    import torch

    from icd_tpu_torch.ops import fused_beam

    flush.zero_()
    # The card sleeps while the host sets the launch up, so the events
    # time the launch and nothing of the host.
    torch.cuda._sleep(SETTLE_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    raw = fused_beam._start(ops, *search)
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end)
    raw["steps"] = int(raw["steps"].item())
    steps = raw["steps"]
    ms = fused_beam.phase_ms(raw["phase_ns"], steps)
    stamps = raw["phase_ns"][:steps + 1].flatten().cpu()
    stamps = torch.cat([stamps[:2], stamps[len(fused_beam.PHASES) + 1:]])
    gaps = stamps.diff()
    check(bool((gaps >= 0).all()), "K2 clock runs forward")
    tick = 0  # the clock's resolution: the gcd of its steps
    for gap in gaps.tolist():
        tick = math.gcd(tick, gap)
    check(abs(ms["total"] - event_ms) <= 0.1 * event_ms,
          "K2 clock vs CUDA events", ms["total"], event_ms)
    log("k2_phases", steps=steps, event_ms=event_ms,
        clock_ms=ms["total"], clock_tick_ns=tick,
        us={name: v * 1e3 for name, v in ms.items()},
        us_per_step={name: ms[name] * 1e3 / steps
                     for name in fused_beam.PHASES})
    return ms


def phase_beam_eval(captioner):
    """The val-split captioner's batch loop over 130 images: three
    batches of 64, the last padded by repeating its last image."""
    import numpy as np
    import torch

    from icd_tpu_torch.beam_eval import caption_images
    from icd_tpu_torch.ops.fused_beam import beam_search_fused
    from icd_tpu_torch.vocabulary import Vocabulary

    vocab = Vocabulary()
    for i in range(VOCAB):
        vocab.add_word("w{}".format(i))
    n = 130
    pool = uint8_images(n, seed=6).numpy()
    img_ids = list(range(1000, 1000 + n))

    def load_batch(ids):
        return pool[[i - 1000 for i in ids]]

    beam_search_fused.launches = 0
    t0 = time.perf_counter()
    rows = caption_images(captioner, img_ids, load_batch, vocab, IMAGES,
                          log=lambda line: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(rows) == n, "beam_eval results", len(rows))
    check([r["image_id"] for r in rows] == img_ids, "beam_eval image ids")
    check(all(isinstance(r["caption"], str) for r in rows),
          "beam_eval captions")
    check(beam_search_fused.launches == 3, "K2 launches for 3 batches",
          beam_search_fused.launches)
    words = [len(r["caption"].split()) for r in rows]
    log("beam_eval", images=n, batch=IMAGES, batches=3,
        k2_launches=beam_search_fused.launches, seconds=seconds,
        seconds_per_caption=seconds / n,
        mean_words=float(np.mean(words)))


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
    phase_k2(phase_path_f32(models), results)
    phase_profile(*phase_serve_bf16(models, results))
    fused = phase_serve_fused_bf16(models, results)
    phase_beam_eval(fused[0])
    phase_profile(*fused, phase="profile_fused",
                  table="profile_fused_beam.txt")

    k1 = dict(name="fused_attention", route="cuda",
              source="icd_tpu_torch/csrc/fused_attention.cu",
              replaces="icd_tpu/ops/fused_attention.py:45",
              library_ms=None, **results["fused_attention"])
    # No single PyTorch call computes a beam search: library_ms is null.
    k2 = dict(name="fused_beam", route="cuda",
              source="icd_tpu_torch/csrc/fused_beam.cu",
              replaces="icd_tpu/ops/fused_beam.py:99",
              library_ms=None, **results["fused_beam"])
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
