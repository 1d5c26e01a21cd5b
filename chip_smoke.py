#!/usr/bin/env python3
"""Drive icd_tpu_torch's paths on one CUDA card: beam search (float and
int8 encoder) and greedy decoding (float and W8A8 decoder) of the
attention model, greedy decoding of the baseline model, the bench
(``python -m icd_tpu_torch.bench``) and the six workload benches
(``python -m icd_tpu_torch.bench_*``), training and teacher-forced
evaluation of both models (f32, --amp, --int8_encoder), the
attention model's --use_bert training and eval with bert-base caption
embeddings, the multi-chip path, the reference's .pth.tar /
resnet101.pth artifacts and the training data path's aids, the COCO
detection eval and the notebook's teacher-forced caption demo, and the
port's JPEG codec with the paths that read image files (captioning,
the val-split beam eval, training, the file-fed serving bench).

    python3 chip_smoke.py            # one card, every phase below
    python3 chip_smoke.py --nccl4    # four cards: mesh_nccl1, then
                                     # mesh_gloo_shared's ranks over NCCL

Phases, one line of output each:

1. build       compile every kernel from csrc/ (one nvcc per source, all
               at once) and print the build seconds; then k1_ptxas,
               k2_ptxas, k3_ptxas and k4_ptxas, registers and spill
               bytes of each bf16 kernel entry of K1 (its gate and
               attention kernels), of K2 and of K3, and of every entry
               of K4, which must show no spills;
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
               and K1 at one row per image (greedy decoding's shape, 64
               images), f32 and bf16 within the same tolerances, timed
               with its bound;
   k3          K3 (the float trunk's eval-mode BN, ReLU and residual
               add in one pass) equal to its plain version, the eager
               chain, at every distinct BN site of ResNet-101 at batch 64
               (bf16 activations, f32 statistics, as served); then one
               whole encoder's epilogue, its 100 launches at batch 64
               through resnet.bn_relu (the trunk's path), timed (CUDA
               events, L2 flushed before, the card asleep while the host
               sets it up) beside its bound and the plain version's
               time, and the host's median time to issue a launch. Every
               later phase reads K3's counter beside K1's and K2's: 100
               launches a float eval forward (serve_bf16,
               serve_fused_bf16, path_f32, greedy, beam_eval, the int8
               calibration's float pass, the f32 validation and demo
               paths, gen_captions_file), none on the int8 trunk and in
               the train steps; the kernels line records each reading;
   k4          K4 (the static-int8 trunk's epilogue: dequant affine,
               residual, ReLU, requantize in one pass) equal to its
               plain version, the eager chain, at every distinct site of
               ResNet-101's int8 trunk at batch 64 (the last block
               writing bf16); then one forward's 100 launches through
               prepared terms, timed as K3 is beside its bound and the
               plain version's time, and the host's median time to issue
               a launch. Later phases read K4's counter too: 100 a
               forward on the int8 greedy and int8 beam paths, 300 on
               beam_eval_int8 (3 batches), none on the float serving
               paths and in the int8 calibration; int8_encoder holds a
               whole int8 forward through K4 equal to the eager chain's
               (bf16 and f32 output) and times the encoder both ways;
   int8_conv   ops.quant.conv2d_int8 (im2col + torch._int_mm) on the card
               at every distinct ResNet-101 convolution site at batch 2
               (the 7x7/2 stem with K padded, the 1x1 and 3x3 sites, the
               1x1 stride-2 downsamples): int32 sums equal to the same
               function on the CPU and to a float64 convolution of the
               int8 values; the dynamic int8_conv once against the CPU;
               one batch-64 site timed with the weights column-major and
               row-major, beside cuDNN's bf16 convolution of that shape;
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
               build/profile_fused_beam.txt);
10. int8_encoder  the static-int8 ResNet-101 calibrated (bf16) on the 16
               images full_width_models uses: (a) its grid on the card
               against the CPU for 2 images, at most one quantization
               step of the last site apart (expected equal; the count of
               differing elements is printed); (b) the relative L2 error
               of the int8 grid against the float bf16 grid at batch 64,
               a quality number (a random trunk is not a trained one: not
               gated); (c) int8 and float encoder ms at batch 64 in bf16,
               peak memory of each, and the int8 encoder's device time by
               ATen op from torch.profiler (build/profile_int8_encoder.txt);
11. greedy     make_attention_captioner: f32 at batch 8, TF32 off, tokens
               through K1 equal to those through its plain version and
               alphas atol 5e-6, K1 launches equal to the steps; then bf16
               at batch 64, max_len 25: encoder ms, decode ms, steps, K1
               launches, captions/s, peak memory;
12. serve_int8_greedy_bf16  make_int8_attention_captioner at batch 64 with
               the float and the W8A8 decoder: encoder ms, decode ms,
               steps, K1 launches, captions/s; qmatmul's int32 sums at the
               decoder's shapes (and 5 rows, and 9,490 columns) equal on
               the card and the CPU;
13. serve_int8_beam_bf16  the int8 encoder feeding the per-step loop (K1),
               the fused search (K2) and the per-step loop with
               int8_grid, batch 64: encoder ms, beam ms, steps,
               launches, captions/s;
14. beam_eval_int8  caption_images with the int8 per-step captioner (the
               CLI's default configuration) over the same 130 images;
15. baseline_f32  the baseline model (baseline_models: full_width_models'
               ResNet-101 with a seeded embed head, a seeded V=10,000,
               E=H=512 decoder with <end> pinned unreachable) through
               make_captioner, f32, TF32 off, batch 8: the features
               against the same encoder on the CPU for one image (max
               error within 1e-3 of the largest feature), and the card's
               greedy tokens against the CPU's from the same features, at
               least 7 of 8 captions equal; neither K1 nor K2 launched;
16. baseline_serve_bf16  batch 64, max_len 25, <end> pinned, through
               make_captioner, make_captioner(int8=True) (dynamic int8
               convolutions), and make_int8_captioner (act_maxes of
               int8_encoder) with the float and the W8A8 decoder: encoder
               ms, decode ms, steps (25), captions/s, peak memory; no K1
               or K2 launch;
17. bench      icd_tpu_torch.bench.measure in its int8 and its bf16 mode on
               the same models at bench.py's shapes (batch 64, 224x224,
               25 steps, 10 repeats, 3 trials): the two JSON lines it
               prints, for each mode.
17b. benches   each workload bench's measure (python -m
               icd_tpu_torch.bench_{int8,attention,beam,fused_beam,train,
               bert}) once at full width with 2 repeats and 1 trial (a
               cut of depth; the benches run 3 trials of 4 to 10), on
               the models above where the shapes are the bench's: its
               rows in its JAX tool's order, and its last line; K1 once
               a decode step on bench_attention's rows (<end> pinned)
               and on the per-step rows of bench_beam and
               bench_fused_beam, K2 once a search on bench_fused_beam's
               fused row (51 steps, <end> pinned), whose first search is
               held against K2's plain version (bf16; in f32 phase_k2's
               gate, and the raw history: step 1's alphas on every row,
               and every step's parents and alphas within 5e-6 for at
               least 7/8 of the images, the rest split by f32 rounding
               at near ties); then k2_split, one line a split image:
               K2 stopped after each step up to it and read through its
               workspace views (parents and alphas equal to the full
               launch's), its first step whose choice differs from the
               plain version's, each pair of candidates ranked
               otherwise with K2's, the f32 plain version's and a
               float64 arbiter's scores on the same beams, the f64 gap
               and both versions' errors; every split must be explained
               (K2's choice the top-k of its own scores, each gap within
               the errors together); no launch on bench_int8,
               bench_train (both families) or bench_bert; then K2 alone
               at the 51-step budget beside its bound;
18. train_step_f32  one train step of full_width_models' attention model,
               f32, TF32 off, dropout 0, batch 4, caption length 12,
               seeded Zipf captions over V=10,000 (testing.seeded_captions),
               on the card and on the CPU from the same parameters: the
               loss within 1e-5 relative and the new BN statistics within
               1e-4; the decoder's gradients from one grid on both devices
               within 1e-5 of each tensor's largest value; through each
               device's own grid, gradients and Adam's moments within 0.06
               (relu elements within the grids' difference of zero take
               the other branch), at most 1 % of the updated parameters'
               elements more than lr / 100 apart; the score bias's
               gradient (zero in exact arithmetic) below 1e-6 of the
               largest gradient. The card's step again with TF32 on must
               fail every one of these limits;
19. train_f32  training.attention.train_epoch over 20 in-memory batches at
               tools/bench_train.py's shapes (batch 32, caption length
               25, V=10,000), dropout 0.5, grad_clip 5, Adam 1e-4: median
               step ms (CUDA events around each step), images/s, epoch
               wall seconds, the frozen encoder's forward ms (events) and
               the rest of the step, one step under torch.profiler
               (device busy ms, idle share of that step and of the
               median step, top kernels), peak memory (and the bytes
               resident before, earlier phases' models), model GFLOP a step
               (the training bench's count) and their share of the f32
               peak; then 30 steps on one batch at decoder_lr 1e-3, whose
               loss must fall below 0.8x its first value;
20. eval_f32   training.attention.make_eval_step over 130 seeded items
               in batches of 64 (the last, of 2, at its own size, as
               evaluate runs it) with train_f32's weights: every item
               against the CPU (losses within 1e-5 relative, at least 99 %
               of argmax predictions equal; the first batch with TF32 on
               must fail the loss limit), and the scorers (METEOR by its
               pure-Python backend) over the result on the host.

21. train_baseline_step_f32, train_baseline, train_amp_step,
    train_int8_step, eval_baseline_f32: the baseline model's step card
    vs CPU, its training bench rows (f32, amp, amp + int8), the --amp and
    --int8_encoder steps of both families, the baseline eval step;
22. bert_f32   bert-base at its published geometry (12 layers, hidden
               768, 12 heads, FFN 3,072, 30,522 pieces, 512 positions),
               seeded weights, f32, TF32 off, over 32 seeded captions of
               8-25 words (bert_vocab: a vocab.txt made from the smoke's
               vocabulary, filled to 30,522): the caption embedder's device
               path on the card against the CPU, padded rows and rows cut
               to their lengths, within 1e-5 of the largest value (TF32
               must exceed it); the forward's ms (events, median of 10)
               beside its bound, the host tokenization's ms with a cold
               and a warm word memo, peak memory;
23. bert_int8  the W8A8 BERT on the card and on the CPU with the CPU's
               int8 inputs shared (testing.SharedQuantization): the int32
               sums of every product of every layer equal, every
               product's float input and the output within 1e-5 (TF32,
               its operands rounded by hand, must exceed it); free-running
               the output error printed, and the CPU's W8A8 within 5 % of
               its f32 forward; its ms beside the f32 forward's;
24. train_bert_step_f32  one --use_bert step (E = 768 decoder, batch 4)
               card vs CPU from the same BERT embeddings, with
               train_step_f32's limits but the own-grid gradients' (0.1),
               the one-grid gradients taken with the CPU's relu branches
               (testing.ReluBranches) within 1e-4; the decoder's table
               bit-identical; TF32 must fail every limit;
25. train_bert 20 --use_bert steps at the training bench's shapes, BERT's
               embeddings made on the card inside each step: step ms,
               images/s, BERT's share of the step, idle share, peak
               memory; 30 steps on one batch must take the loss below 0.8x;
26. eval_bert_f32  the eval step on embeddings of the captions cut to
               their lengths over 130 items: losses within 1e-5 of the
               CPU's (TF32 beyond), predictions equal.
27. mesh_nccl1  a one-rank NCCL group in this process, a (1, 1) mesh:
               three f32 steps of each family (mesh_models; batch 32,
               caption length 25, V=10,000, lr 1e-4) through the mesh
               path (testing.mesh_train: BN statistics, loss counts and
               the gradient bucket over the group) bit-equal to the same
               steps without a mesh; the step's median ms beside the
               unmeshed step's (in turns); the sharded greedy and beam
               captioners at batch 64 bf16 with tokens equal to the
               one-card captioners they wrap, K1 launched once a decode
               step and its first call held against its plain version.
               Writes build/mesh/{models,reference}.pt;
28. mesh_gloo_shared  four gloo ranks spawned on the one card
               (parallel.run_ranks), a (2, 2) mesh, the decoders split
               over the vocabulary: the same three steps of each family
               against mesh_nccl1's one-rank run within MESH_LIMITS,
               each of which a run with TF32 on or with the n_model-times
               gradient of a library collective's backward must exceed;
               the sharded captioners at batch 64 bf16 (tokens equal to
               the one-card captioner on each data shard's rows; K1 on
               every rank, its first call on rank 0 against its plain
               version; in f32 the gathered greedy tokens equal to one
               card's batch of 64); wall seconds of four ranks sharing
               one card, a correctness run, not a scaling figure.
29. pth_artifacts  the reference's artifacts at full width: the attention
               and baseline models of the phases above written as the
               port's .ckpt, exported by ``python -m
               icd_tpu_torch.export_reference`` to whole-module .pth.tar
               files pickled from the reference skeleton
               (testing.write_reference_skeleton, under build/), and the
               trunk as a torchvision-named models/resnet101.pth; each
               .pth.tar loaded back (load_checkpoint: the restricted
               unpickler and convert) to trees equal to the .ckpt's,
               exported again and reloaded equal; the train entry's model
               building from scratch with resnet101.pth present (its trunk
               the file's) and from --checkpoint x.pth.tar, one f32 step
               each at batch 32, caption length 25; batch-64 bf16 captions
               of the loaded model through the per-step beam of
               gen_captions (K1, its first call against its plain version)
               and through beam_eval's --fused captioner over 130 images
               (K2, one launch a batch), equal to the .ckpt's; K2 against
               its plain version on the loaded model in f32 (batch 8); the
               write, export, load and reload seconds and the files' bytes;
30. device_image_cache  ICD_TPU_DEVICE_IMAGE_CACHE=12 at COCO-2014 train's
               size (82,783 distinct 224x224x3 uint8 images: the buffer's
               bytes and the peak memory), train_f32's cell for 40 steps
               whose 256 image ids repeat 5 times each, as COCO's captions
               do (pixels made on the host from each id's seed): losses
               equal to the bit to the direct path's (both through the
               train loop's staging), hits and misses, median step ms of
               each; then a budget of 3 batches, which evicts while the
               producer runs two batches ahead, equal to the bit too;
31. prefetch_async_ckpt  20 steps of train_f32's cell fed three ways, in
               turns and again in reverse: each batch shipped by the step
               (sync), read on a thread and shipped by the step
               (host_thread, the loop before device_prefetch) and staged by device_prefetch
               (side stream, producer thread): losses equal to the bit;
               in every run a checkpoint after step 10 while training goes
               on, written synchronously or (device_prefetch's first run)
               by the ICD_TPU_CKPT_ASYNC writer, every file's trees and
               Adam state equal; the median step ms before the save, the
               save call's ms, the next step's and the median after;
32. profile_train  a 4-step train_epochs run under ICD_TPU_PROFILE: the
               Chrome trace exists and holds CUDA kernels and one
               train_step span a step and a checkpoint span; its bytes and
               top kernels. None of 30-32 launches K1 or K2 (checked).
33. coco_eval  the port's COCO detection eval on the machine's host (no
               card work): the mask library built by g++ (seconds, path);
               on 64 seeded 480x640 masks decode(encode(m)) == m, area ==
               m.sum() and iou equal to the dense masks' IoU by numpy;
               perfect detections give AP 1.0 for bbox and segm; then
               seeded instances at val2017's density (640x480, 80
               categories, 7.36 objects an image, 15 % crowd; results one
               a near copy of each object, the rest random) through
               loadRes, evaluate, accumulate and summarize, host seconds
               of each: bbox over 1,000 images x 100 results (a fifth of
               val2017), segm (polygon ground truth, RLE results from
               frPyObjects) over 500 x 20;
34. captions_demo  captions_demo.caption_teacher_forced on the card for
               the attention, baseline and --use_bert models at full
               width (3 seeded images, Zipf captions, f32, TF32 off)
               against the CPU: each caption's loss (but at <end>) within
               eval_f32's 1e-5, from the card's decoder on the CPU's
               encoder output and from the whole forward, which TF32 must
               exceed; words that agree and the captions printed; no K1
               or K2 launch.
35. jpeg_codec  the port's JPEG codec (native/jpeg.cpp) built by g++ on
               this host (seconds); testing.codec_corpus(), 24 files of
               its encoder (each subsampling, progressive, restart
               markers, grey, odd sizes, 640x480), decoded to
               CODEC_CORPUS_DIGEST, the digest of PIL's decode of them
               (tests/test_torch_jpeg.py): PIL's pixels with no PIL;
               decode, decode + resize and encode ms of a 640x480 image
               on one thread;
36. jpeg_corpus  python -m icd_tpu_torch.make_synthetic_coco into
               build/slice13 (200 train and 130 val images at 640x480,
               realistic captions, 5 an image) and python -m
               icd_tpu_torch.init --vocab True --vocab_threshold 1;
               ops.image.resize_bilinear (JAX's antialiased bilinear)
               of 8 decoded val images, 640x480 -> 224x224, on the card
               within 2e-3 of the CPU (0-255 scale), its max error
               printed; the attention model over that vocabulary saved as
               checkpoints/s13_0.ckpt (full_width_models' ResNet-101 with
               BN re-estimated on 16 corpus images, a seeded steered
               decoder);
37. gen_captions_file  python -m icd_tpu_torch.gen_captions on one val
               JPEG, --encoder float --dtype f32 (TF32 off, per-step
               beam): K1 once a step, its first call against its plain
               version (f32 limits), the output lines equal to the same
               CLI's on the CPU;
38. beam_eval_files  python -m icd_tpu_torch.beam_eval --fused and the
               per-step run over the 130 val files (int8 trunk, bf16):
               130 results each, K2 three launches on --fused, K1 at
               least three on the per-step run (its first call against
               the plain version); K2 against its plain version and the
               per-step search at this vocabulary in f32 (8 val files);
39. train_files  python -m icd_tpu_torch.train (attention, f32, batch 32,
               8 loader workers, one epoch: 32 steps) over the corpus's
               files, and again fed the same images as arrays decoded
               before it: losses equal to the bit; the median step ms of
               each (each loss fetched, so the loop's Time column is the
               step); no K1 or K2 launch;
40. serving_e2e  bench_serving_e2e.run (python -m
               icd_tpu_torch.bench_serving_e2e's workload) with
               baseline_models' full-width models over 8 batches of 64:
               host decode images/s by thread count, h2d GB/s, end-to-end
               and device-only captions/s, min(host, device), the threads
               needed, the first batch's captions equal to the resident
               captioner's; no K1 or K2 launch.

Every path is driven with the launch counts set to 0 just before it and
read just after; each must have launched its kernels, and the baseline,
train, eval and BERT paths, which have none, none. The mesh phases'
train steps launch neither K1 nor K2; their sharded captioners launch
K1 on every rank.

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
import sys
import time

from icd_tpu_torch.bench_train import decoder_train_gflops
from icd_tpu_torch.kernels import KERNELS
from icd_tpu_torch.utils.benchmarking import (
    BF16_FLOP_PER_S, F32_FLOP_PER_S, INT8_OP_PER_S, RESNET101_GFLOP,
    SETTLE_CYCLES, card_line, device_us, greedy_steps, launch_counts, median,
    reset_launches, result, roofline_ms, time_ms, trial_seconds)

# Serving shapes: bench.py:36-38 and tools/bench_beam.py:16-20.
IMAGES, BEAMS, PIX, ENC_DIM, ATT_DIM, DEC_DIM = 64, 5, 196, 2048, 512, 512
EMBED, VOCAB = 512, 10000
START_ID, END_ID = VOCAB - 3, VOCAB - 2
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def check(ok, what, *values):
    """Fail the run (non-zero exit) unless ``ok``."""
    if not ok:
        raise SystemExit("chip_smoke: check failed: {} {}".format(
            what, values))


STARTED = time.perf_counter()


def log(phase, **fields):
    """One JSON line of a phase's readings, with the seconds since the
    script started."""
    print(json.dumps(dict(phase=phase, **fields, elapsed_s=round(
        time.perf_counter() - STARTED, 1))), flush=True)


def expect_launches(results, what, counts=None, **expected):
    """Each kernel's launches since ``reset_launches`` (or ``counts``, a
    dict of them): fails unless each count given in ``expected`` (by the
    kernel's name in ``kernels.KERNELS``; None: read, not checked)
    equals it, and records every kernel's under
    ``results[kernel]["launches_by_path"][what]``. Returns the counts."""
    counts = launch_counts() if counts is None else counts
    for name, want in expected.items():
        check(want is None or counts[name] == want,
              "{}: {} launches".format(what, name), counts[name], want)
    for name, n in counts.items():
        results[name]["launches_by_path"][what] = n
    return counts


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
    ptxas_line("k3_ptxas", reports["bn_epilogue"][1], ("bn_epilogue",))
    ptxas_line("k4_ptxas", reports["int8_epilogue"][1], ("int8_epilogue",),
               keep=lambda name: "int8_epilogue" in name)


def ptxas_line(phase, report, kernels, keep=None):
    """ptxas's report for the bf16 entry functions whose names hold one
    of ``kernels`` (or those ``keep(name)`` takes): registers and spill
    bytes of each; fails on any spill."""
    entries = []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            if keep is None:
                taken = ("nv_bfloat16" in name
                         and any(k in name for k in kernels))
            else:
                taken = keep(name)
            entries.append(dict(entry=name) if taken else None)
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

    from icd_tpu_torch.k1_bench import k1_inputs
    from icd_tpu_torch.ops.fused_attention import (bound_ms,
                                                   fused_attention,
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
    bound, bound_by = bound_ms(args16, (ctx, alpha))
    results["fused_attention"].update(
        max_abs_err=bf16_ctx_err, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=bound_by,
        phase_us=k1_phases(args16, flush),
        rows_per_image_1=k1_one_row(args32, flush))
    log("k1", shapes=dict(images=IMAGES, rows_per_image=BEAMS, P=PIX,
                          D=ENC_DIM, A=ATT_DIM, H=DEC_DIM),
        f32_ctx_err=f32_ctx_err, f32_alpha_err=f32_alpha_err,
        bf16_ctx_err=bf16_ctx_err, bf16_alpha_err=bf16_alpha_err,
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, share_of_bound=bound / kernel_ms,
        rows_per_image_1=results["fused_attention"]["rows_per_image_1"])


def phase_k3(results):
    """K3 against the eager chain at every distinct BN site of ResNet-101
    at batch 64 (bf16, f32 statistics), then one encoder's 100 launches
    through ``resnet.bn_relu`` (the trunk's path: prepared terms) timed
    beside their bound and the plain version, and the host's time to
    issue them."""
    import torch

    from icd_tpu_torch.models.resnet import bn_relu, bn_terms
    from icd_tpu_torch.ops.bn_epilogue import bn_epilogue_reference, bound_ms
    from icd_tpu_torch.testing import bn_epilogue_case, bn_epilogue_sites

    gen = torch.Generator().manual_seed(3)
    sites = bn_epilogue_sites(IMAGES)
    cases, plain = {}, {}
    with torch.inference_mode():
        for site in sites:
            if site in cases:
                continue
            x, bn, cd, r, sc = bn_epilogue_case(*site, gen, "bf16_keep",
                                                "cuda")
            cases[site] = (x, bn, cd, r, sc)
            plain[site] = (x, bn_terms(bn, cd), r, None if sc is None else
                           (sc[0], bn_terms(sc[1], cd)))
            check(torch.equal(bn_relu(*cases[site]),
                              bn_epilogue_reference(*plain[site])),
                  "K3 equals the eager chain", site)

        def kernel():
            for site in sites:
                bn_relu(*cases[site])

        def reference():
            for site in sites:
                bn_epilogue_reference(*plain[site])

        reset_launches()
        kernel()
        torch.cuda.synchronize()
        check(len(sites) == 100, "K3's sites in an encoder", len(sites))
        expect_launches(results, "k3_encoder_bf16", bn_epilogue=100)
        host = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kernel()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        host_us = sorted(host)[len(host) // 2] / len(sites) * 1e6
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
        kernel_ms = time_ms(kernel, flush=flush, settle=True)
        plain_ms = time_ms(reference, flush=flush, settle=True)
    bound = bound_ms(sites)
    results["bn_epilogue"].update(
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
        host_us_per_launch=host_us)
    log("k3", batch=IMAGES, sites=len(sites), distinct_sites=len(cases),
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", share_of_bound=bound / kernel_ms,
        host_us_per_launch=host_us)


def phase_k4(results):
    """K4 against the eager chain at every distinct site of ResNet-101's
    int8 trunk at batch 64 (the last block writing bf16, as served),
    then one forward's 100 launches through prepared terms timed beside
    their bound and the plain chain, and the host's time to issue a
    launch."""
    import torch

    from icd_tpu_torch.ops.int8_epilogue import (Terms, bound_ms,
                                                 int8_epilogue,
                                                 int8_epilogue_reference)
    from icd_tpu_torch.testing import int8_epilogue_case, int8_epilogue_sites

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    sites = int8_epilogue_sites(IMAGES)
    cases, plain = {}, {}
    with torch.inference_mode():
        for site in sites:
            if site in cases:
                continue
            acc, terms, other = int8_epilogue_case(*site, gen, "cuda")
            cases[site] = (acc, Terms(*terms), other, bf16)
            plain[site] = (acc, terms, other, bf16)
            check(torch.equal(int8_epilogue(*cases[site]),
                              int8_epilogue_reference(*plain[site])),
                  "K4 equals the eager chain", site)

        def kernel():
            for site in sites:
                int8_epilogue(*cases[site])

        def reference():
            for site in sites:
                int8_epilogue_reference(*plain[site])

        reset_launches()
        kernel()
        torch.cuda.synchronize()
        check(len(sites) == 100, "K4's sites in a forward", len(sites))
        expect_launches(results, "k4_forward_bf16", int8_epilogue=100)
        host = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kernel()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        host_us = sorted(host)[len(host) // 2] / len(sites) * 1e6
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
        kernel_ms = time_ms(kernel, flush=flush, settle=True)
        plain_ms = time_ms(reference, flush=flush, settle=True)
    bound = bound_ms(sites)
    results["int8_epilogue"].update(
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
        host_us_per_launch=host_us)
    log("k4", batch=IMAGES, sites=len(sites), distinct_sites=len(cases),
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", share_of_bound=bound / kernel_ms,
        host_us_per_launch=host_us)


def k1_one_row(args32, flush):
    """K1 at greedy decoding's shape, one row per image for 64 images, in
    f32 and bf16 against its plain version (the tolerances of phase_k1),
    and its bf16 time beside its bound and the plain version's."""
    import torch

    from icd_tpu_torch.ops.fused_attention import (bound_ms,
                                                   fused_attention,
                                                   fused_attention_reference)

    one32 = args32[:2] + (args32[2][:IMAGES].contiguous(),) + args32[3:]
    ctx, alpha = fused_attention(*one32)
    ref_ctx, ref_alpha = fused_attention_reference(*one32)
    torch.cuda.synchronize()
    f32_ctx_err = (ctx - ref_ctx).abs().max().item()
    f32_alpha_err = (alpha - ref_alpha).abs().max().item()
    check(f32_ctx_err <= 2e-5, "one row: f32 ctx error", f32_ctx_err)
    check(f32_alpha_err <= 2e-6, "one row: f32 alpha error", f32_alpha_err)
    one16 = tuple(t.to(torch.bfloat16) for t in one32)
    ctx, alpha = fused_attention(*one16)
    ref_ctx, ref_alpha = fused_attention_reference(*(t.float()
                                                     for t in one16))
    torch.cuda.synchronize()
    err = (ctx.float() - ref_ctx).abs()
    check(bool((err <= 2 ** -8 * ref_ctx.abs() + 1e-5).all()),
          "one row: bf16 ctx error", err.max().item())
    bf16_alpha_err = (alpha - ref_alpha).abs().max().item()
    check(bf16_alpha_err <= 1e-5, "one row: bf16 alpha error",
          bf16_alpha_err)
    kernel_ms = time_ms(lambda: fused_attention(*one16), flush=flush,
                        settle=True)
    plain_ms = time_ms(lambda: fused_attention_reference(*one16),
                       flush=flush, settle=True)
    bound, bound_by = bound_ms(one16, (ctx, alpha))
    return dict(images=IMAGES, f32_ctx_err=f32_ctx_err,
                f32_alpha_err=f32_alpha_err, bf16_ctx_err=err.max().item(),
                bf16_alpha_err=bf16_alpha_err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


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

    plain = resnet.bn_relu

    def estimating(x, bn, compute_dtype=None, residual=None, shortcut=None):
        for y, m in [(x, bn)] + ([shortcut] if shortcut else []):
            yf = y.float().reshape(-1, y.shape[-1])
            m.mean.copy_(yf.mean(0))
            m.var.copy_(yf.var(0))
        return plain(x, bn, compute_dtype, residual, shortcut)

    resnet.bn_relu = estimating
    try:
        with torch.no_grad():
            encoder_attention_forward(encoder, imgs.to("cuda"))
    finally:
        resnet.bn_relu = plain


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
    """decode_step and the W8A8 greedy step through K1's plain version,
    for the comparison runs."""
    import icd_tpu_torch.decoding.greedy_attention as greedy
    import icd_tpu_torch.models.attention as attention
    from icd_tpu_torch.ops.fused_attention import fused_attention_reference

    kernel = attention.fused_attention
    attention.fused_attention = fused_attention_reference
    greedy.fused_attention = fused_attention_reference
    try:
        yield
    finally:
        attention.fused_attention = kernel
        greedy.fused_attention = kernel


@contextlib.contextmanager
def plain_int8_epilogue():
    """The int8 trunk's epilogues through K4's plain version, the eager
    chain, for the comparison runs."""
    import icd_tpu_torch.models.resnet_int8 as resnet_int8
    from icd_tpu_torch.ops.int8_epilogue import int8_epilogue_reference

    kernel = resnet_int8.int8_epilogue
    resnet_int8.int8_epilogue = int8_epilogue_reference
    try:
        yield
    finally:
        resnet_int8.int8_epilogue = kernel


def phase_path_f32(models, results):
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
    reset_launches()
    grid = captioner.encode(imgs)
    expect_launches(results, "path_f32", bn_epilogue=100, int8_epilogue=0)
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

    reset_launches()
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
    results["fused_beam"]["max_abs_err"] = max(err, err64)
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

    encoder, decoder = models
    captioner = make_beam_captioner(encoder, decoder, START_ID, END_ID,
                                    beam_size=BEAMS,
                                    compute_dtype=torch.bfloat16,
                                    device="cuda")
    imgs = uint8_images(IMAGES, seed=3).cuda()
    captioner(imgs)  # warm-up: kernel load, cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    grid = captioner.encode(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = captioner.decode(grid)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()

    launches = expect_launches(results, "serve_bf16",
                               fused_attention=out["steps"], bn_epilogue=100,
                               int8_epilogue=0)["fused_attention"]
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


def profiled(fn):
    """Run ``fn`` once under torch.profiler: (its result, wall ms, device
    busy ms, [(device us, count, kernel name)] largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = sorted(((device_us(e), e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     reverse=True)
    return out, wall_ms, sum(k[0] for k in kernels) / 1e3, kernels


def phase_profile(captioner, grid, phase="profile",
                  table="profile_beam.txt"):
    """One beam search of the serving batch under torch.profiler: device
    busy time against wall time, and the kernels that take it."""
    out, wall_ms, busy_ms, kernels = profiled(lambda: captioner.decode(grid))
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, table), "w") as f:
        for us, count, name in kernels:
            f.write("{:12.1f} us {:6d}x  {}\n".format(us, count, name))
    log(phase, steps=out["steps"], wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
        top=[dict(name=name[:60], ms=us / 1e3, count=count)
             for us, count, name in kernels[:10]])


def phase_serve_fused_bf16(models, results):
    import torch

    from icd_tpu_torch.decoding.serve import make_beam_captioner
    from icd_tpu_torch.ops import fused_beam

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

    reset_launches()
    t0 = time.perf_counter()
    grid = captioner.encode(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = captioner.decode(grid)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()

    launches = expect_launches(results, "serve_fused_bf16", fused_attention=0,
                               fused_beam=1, bn_epilogue=100,
                               int8_epilogue=0)["fused_beam"]
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
    bound_ms, bound_by = fused_beam.bound_ms(ops, BEAMS, steps)
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


def phase_beam_eval(captioner, results, phase="beam_eval"):
    """The val-split captioner's batch loop over 130 images: three
    batches of 64, the last padded by repeating its last image. A fused
    captioner launches K2 once a batch and K1 never; a per-step one K1
    once a step."""
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

    reset_launches()
    t0 = time.perf_counter()
    rows = caption_images(captioner, img_ids, load_batch, vocab, IMAGES,
                          log=lambda line: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(rows) == n, phase + " results", len(rows))
    check([r["image_id"] for r in rows] == img_ids, phase + " image ids")
    check(all(isinstance(r["caption"], str) for r in rows),
          phase + " captions")
    # The float trunk launches K3 100 times a batch, the int8 one K4.
    int8 = captioner.qresnet is not None
    fused = captioner.beam_fn is beam_search_fused
    counts = expect_launches(
        results, phase, fused_attention=0 if fused else None,
        fused_beam=3 if fused else 0, bn_epilogue=0 if int8 else 300,
        int8_epilogue=300 if int8 else 0)
    k1, k2 = counts["fused_attention"], counts["fused_beam"]
    check(fused or k1 >= 3, "K1 launches for 3 batches", k1, k2)
    words = [len(r["caption"].split()) for r in rows]
    log(phase, images=n, batch=IMAGES, batches=3, k1_launches=k1,
        k2_launches=k2, int8_encoder=captioner.qresnet is not None,
        seconds=seconds, seconds_per_caption=seconds / n,
        mean_words=float(np.mean(words)))


def resnet101_sites():
    """Every distinct convolution of ResNet-101 on a 224x224 image, as
    (input HWC, kernel, Cout, stride, padding), in call order, recorded
    on the meta device."""
    import torch

    from icd_tpu_torch.models.resnet import ResNet, resnet_forward

    sites = []

    def recording(x, w, stride=1, padding=0):
        site = (tuple(x.shape[1:]), w.shape[2], w.shape[0], stride, padding)
        if site not in sites:
            sites.append(site)
        return torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w, stride=stride,
            padding=padding).permute(0, 2, 3, 1)

    with torch.device("meta"):
        resnet_forward(ResNet(), torch.empty(1, 224, 224, 3),
                       conv=recording)
    return sites


def phase_int8_conv():
    """conv2d_int8 on the card against the CPU and a float64 convolution
    at every distinct ResNet-101 site (batch 2): equal int32 sums."""
    import torch
    import torch.nn.functional as F

    from icd_tpu_torch.ops.quant import conv2d_int8, gemm_layout, int8_conv

    gen = torch.Generator().manual_seed(11)
    sites = resnet101_sites()
    checked = []
    for (h, w, cin), k, cout, stride, pad in sites:
        x = torch.randint(-127, 128, (2, h, w, cin), generator=gen,
                          dtype=torch.int8)
        wq = gemm_layout(torch.randint(-127, 128, (k, k, cin, cout),
                                       generator=gen, dtype=torch.int8))
        out = conv2d_int8(x.cuda(), wq.cuda(), stride, pad)
        ref64 = F.conv2d(x.cuda().double().permute(0, 3, 1, 2),
                         wq.cuda().double().permute(3, 2, 0, 1),
                         stride=stride, padding=pad).permute(0, 2, 3, 1)
        cpu = conv2d_int8(x, wq, stride, pad)
        torch.cuda.synchronize()
        check(out.dtype == torch.int32, "int32 sums", out.dtype)
        check(torch.equal(out.cpu(), cpu), "int8 conv card vs CPU",
              (h, cin, k, cout, stride))
        check(torch.equal(out.double(), ref64), "int8 conv vs float64",
              (h, cin, k, cout, stride))
        checked.append([h, cin, k, cout, stride])
    # The dynamic (per-call quantized) convolution, once.
    xf = torch.randn(2, 56, 56, 64, generator=gen)
    wf = torch.randn(64, 64, 3, 3, generator=gen) * 0.05
    dyn = int8_conv(xf.cuda(), wf.cuda(), 1, 1).cpu()
    dyn_ref = int8_conv(xf, wf, 1, 1)
    dyn_err = (dyn - dyn_ref).abs().max().item()
    check(dyn_err <= 1e-5 * dyn_ref.abs().max().item(),
          "dynamic int8_conv card vs CPU", dyn_err)
    # One batch-64 site (layer 1's conv3), weights column-major (as the
    # port stores them) and row-major, beside cuDNN's bf16 convolution.
    x = torch.randint(-127, 128, (IMAGES, 56, 56, 64), generator=gen,
                      dtype=torch.int8).cuda()
    wq = torch.randint(-127, 128, (1, 1, 64, 256), generator=gen,
                       dtype=torch.int8).cuda()
    wcol = gemm_layout(wq)
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # NCHW view, NHWC memory
    wb = wq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    ms = dict(column_major=time_ms(lambda: conv2d_int8(x, wcol)),
              row_major=time_ms(lambda: conv2d_int8(x, wq.contiguous())),
              cudnn_bf16=time_ms(lambda: F.conv2d(xb, wb)))
    log("int8_conv", sites=len(checked), shapes=checked,
        dynamic_err_vs_cpu=dyn_err,
        dynamic_equal_to_cpu=bool(torch.equal(dyn, dyn_ref)),
        timed_site=dict(images=IMAGES, hw=56, cin=64, cout=256),
        timed_site_ms=ms, card=card_line())


def op_split_ms(prof):
    """Device ms by ATen op (the kernels each op launched itself)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        us = device_us(e)
        if e.device_type == DeviceType.CPU and us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def int8_block_errors(resnet, qresnet, imgs):
    """Relative L2 error of the int8 trunk against the float one, f32,
    block by block: each int8 block fed the float block's input (local)
    and the int8 trunk's own output (cumulative). Tells a quantization
    fault (a large local error) from a trunk that amplifies small ones."""
    import torch

    from icd_tpu_torch.models.resnet import (_bottleneck, bn_relu, conv2d,
                                             max_pool)
    from icd_tpu_torch.models.resnet_int8 import _qconv
    from icd_tpu_torch.ops.image import normalize_imagenet

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def qblock(qb, x, stride):
        h = torch.relu(_qconv(x, qb["conv1"]))
        h = torch.relu(_qconv(h, qb["conv2"], stride=stride, padding=1))
        h = _qconv(h, qb["conv3"])
        if "downsample" in qb:
            return torch.relu(h + _qconv(x, qb["downsample"], stride=stride))
        return torch.relu(h + x)

    local, cumulative = [], []
    with torch.inference_mode():
        x = normalize_imagenet(imgs)
        f = bn_relu(conv2d(x, resnet.stem.conv, 2, 3), resnet.stem.bn)
        q = torch.relu(_qconv(x, qresnet["stem"], stride=2, padding=3))
        stem = rel(q, f)
        f, q = max_pool(f), max_pool(q)
        for blocks, qblocks in zip(resnet.layers, qresnet["layers"]):
            for block, qb in zip(blocks, qblocks):
                nxt = _bottleneck(block, f, None)
                local.append(rel(qblock(qb, f, block.stride), nxt))
                q = qblock(qb, q, block.stride)
                f = nxt
            cumulative.append(rel(q, f))
    local.sort()
    return dict(stem=stem, local_min=local[0],
                local_median=local[len(local) // 2], local_max=local[-1],
                cumulative_after_each_stage=cumulative)


def phase_int8_encoder(models, results):
    """Calibrate and quantize; the int8 grid against the CPU and against
    the float grid; int8 and float encoder ms. Returns the act_maxes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from icd_tpu_torch.decoding.serve import (build_int8_backbone,
                                              make_beam_captioner)
    from icd_tpu_torch.models.encoder import encoder_attention_forward_int8
    from icd_tpu_torch.models.resnet_int8 import N_SITES_RESNET101, tree_to

    encoder, decoder = models
    bf16 = torch.bfloat16
    reset_launches()
    t0 = time.perf_counter()
    qresnet, act_maxes = build_int8_backbone(
        encoder, bf16, "cuda", calib_imgs=uint8_images(16, seed=1))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # Calibration: one float forward over the 16 images.
    expect_launches(results, "int8_calibration", bn_epilogue=100,
                    int8_epilogue=0)
    check(act_maxes.shape == (N_SITES_RESNET101,)
          and bool(np.isfinite(act_maxes).all()), "act_maxes",
          act_maxes.shape)

    # (a) the card against the CPU on the same tree and 2 images.
    imgs2 = uint8_images(2, seed=8)
    with torch.inference_mode():
        grid = encoder_attention_forward_int8(qresnet, imgs2.cuda(), bf16)
        cpu = encoder_attention_forward_int8(tree_to(qresnet, "cpu"), imgs2,
                                             bf16)
    diff = (grid.cpu().float() - cpu.float()).abs()
    last = qresnet["layers"][-1][-1]["conv3"]
    step = (1.0 / last["inv_in"]).item()
    check(grid.shape == (2, 14, 14, ENC_DIM), "int8 grid shape", grid.shape)
    check(diff.max().item() <= step, "int8 grid card vs CPU",
          diff.max().item(), step)

    # (b) and (c): batch 64, bf16, the int8 and the float encoder.
    imgs = uint8_images(IMAGES, seed=3).cuda()
    int8 = make_beam_captioner(None, decoder, START_ID, END_ID,
                               beam_size=BEAMS, compute_dtype=bf16,
                               device="cuda", qresnet=qresnet)
    flt = make_beam_captioner(encoder, decoder, START_ID, END_ID,
                              beam_size=BEAMS, compute_dtype=bf16,
                              device="cuda")
    gq, gf = int8.encode(imgs).float(), flt.encode(imgs).float()
    check(bool(gq.isfinite().all()), "finite int8 grid")
    # K4 against the eager chain over a whole int8 forward, bf16 and f32.
    with torch.inference_mode():
        k4_grids = [encoder_attention_forward_int8(qresnet, imgs, dt)
                    for dt in (bf16, torch.float32)]
        with plain_int8_epilogue():
            eager_grids = [encoder_attention_forward_int8(qresnet, imgs, dt)
                           for dt in (bf16, torch.float32)]
    check(all(torch.equal(a, b) for a, b in zip(k4_grids, eager_grids)),
          "int8 forward through K4 equals the eager chain")
    del k4_grids, eager_grids
    rel_l2 = ((gq - gf).norm() / gf.norm()).item()
    blocks = int8_block_errors(encoder.resnet, qresnet, imgs2.cuda())
    ms, peak = {}, {}
    with plain_int8_epilogue():
        ms["int8_eager_epilogue"] = time_ms(lambda: int8.encode(imgs),
                                            iters=10, warmup=2)
    for name, cap in (("int8", int8), ("float", flt)):
        ms[name] = time_ms(lambda: cap.encode(imgs), iters=10, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        cap.encode(imgs)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - before
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        int8.encode(imgs)
        torch.cuda.synchronize()
    split = op_split_ms(prof)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "profile_int8_encoder.txt"), "w") as f:
        for name, v in split.items():
            f.write("{:12.3f} ms  {}\n".format(v, name))
    groups = dict(int_mm=0.0, copies=0.0, elementwise=0.0)
    for name, v in split.items():
        if name == "aten::_int_mm":
            groups["int_mm"] += v
        elif name in ("aten::cat", "aten::copy_", "aten::fill_"):
            groups["copies"] += v
        else:
            groups["elementwise"] += v
    log("int8_encoder", calibration_images=16, sites=len(act_maxes),
        build_seconds=build_s, grid_elements_differing_card_vs_cpu=int(
            (diff > 0).sum()), grid_max_err_card_vs_cpu=diff.max().item(),
        last_site_step=step, rel_l2_vs_float_bf16=rel_l2,
        rel_l2_f32_by_block=blocks,
        int8_encoder_ms=ms["int8"], float_encoder_ms=ms["float"],
        int8_encoder_eager_epilogue_ms=ms["int8_eager_epilogue"],
        int8_forward_k4_equals_eager=True,
        int8_encoder_peak_bytes=peak["int8"],
        float_encoder_peak_bytes=peak["float"],
        int8_device_ms_by_group=groups,
        int8_device_ms_top_ops=dict(list(split.items())[:12]),
        card=card_line())
    return act_maxes


def timed_serve(captioner, imgs):
    """One warmed-up batch through ``captioner``: (output, encoder ms,
    decode ms, each kernel's launches, peak bytes). The counts are set to
    0 just before the batch and read just after it."""
    import torch

    captioner(imgs)  # warm-up: cuBLASLt and cuDNN plans, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    grid = captioner.encode(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = captioner.decode(grid)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = launch_counts()
    return (out, (t1 - t0) * 1e3, (t2 - t1) * 1e3, launches,
            torch.cuda.max_memory_allocated())


def check_greedy(out, n, max_len, what):
    """Shapes, finite alphas, step 1's alphas softmax rows; returns how
    many captions finished."""
    toks, alphas = out
    check(toks.shape == (n, max_len) and alphas.shape == (n, max_len, PIX),
          what + " shapes", toks.shape, alphas.shape)
    check(bool(alphas.isfinite().all()), what + " finite alphas")
    ended = (toks == END_ID).any(1)
    sums = alphas.sum(-1)
    check(bool(((sums - 1).abs()[:, 0] < 1e-3).all()),
          what + " step-1 alphas are softmax rows")
    return int(ended.sum())


def phase_greedy(models, results):
    import torch

    from icd_tpu_torch.decoding.serve import make_attention_captioner
    from icd_tpu_torch.ops.fused_attention import fused_attention

    encoder, decoder = models
    max_len = 25
    f32 = make_attention_captioner(encoder, decoder, START_ID, END_ID,
                                   max_len=max_len,
                                   compute_dtype=torch.float32,
                                   device="cuda")
    check(not torch.backends.cudnn.allow_tf32, "TF32 off for f32")
    grid = f32.encode(uint8_images(8, seed=2))
    reset_launches()
    toks, alphas = f32.decode(grid)
    torch.cuda.synchronize()
    launches = fused_attention.launches
    steps = greedy_steps(toks, END_ID)
    check(launches == steps, "f32 greedy K1 launches vs steps", launches,
          steps)
    with plain_attention():
        ref_toks, ref_alphas = f32.decode(grid)
    check(fused_attention.launches == launches, "K1 launched by plain run")
    check(torch.equal(toks, ref_toks), "greedy tokens: K1 vs plain")
    f32_alpha_err = (alphas - ref_alphas).abs().max().item()
    check(f32_alpha_err <= 5e-6, "greedy alphas: K1 vs plain", f32_alpha_err)

    bf16 = make_attention_captioner(encoder, decoder, START_ID, END_ID,
                                    max_len=max_len,
                                    compute_dtype=torch.bfloat16,
                                    device="cuda")
    imgs = uint8_images(IMAGES, seed=3).cuda()
    out, enc_ms, dec_ms, launches64, peak = timed_serve(bf16, imgs)
    steps64 = greedy_steps(out[0], END_ID)
    k1 = expect_launches(results, "greedy_bf16", launches64,
                         fused_attention=steps64, bn_epilogue=100,
                         int8_epilogue=0)["fused_attention"]
    finished = check_greedy(out, IMAGES, max_len, "bf16 greedy")
    log("greedy", f32=dict(images=8, steps=steps, k1_launches=launches,
                           alpha_err_vs_plain=f32_alpha_err),
        images=IMAGES, max_len=max_len, encoder_ms=enc_ms, decode_ms=dec_ms,
        steps=steps64, k1_launches=k1,
        captions_per_s=IMAGES / ((enc_ms + dec_ms) / 1e3),
        peak_memory_bytes=peak, finished=finished, card=card_line())


def phase_serve_int8_greedy(models, act_maxes, results):
    import torch

    from icd_tpu_torch.decoding.serve import make_int8_attention_captioner
    from icd_tpu_torch.ops.qlinear import qmatmul, quantize_linear
    from icd_tpu_torch.ops.quant import int_mm

    encoder, decoder = models
    max_len = 25
    imgs = uint8_images(IMAGES, seed=3).cuda()
    runs = {}
    for int8_decoder in (False, True):
        cap = make_int8_attention_captioner(
            encoder, decoder, START_ID, END_ID, max_len=max_len,
            compute_dtype=torch.bfloat16, act_maxes=act_maxes,
            int8_decoder=int8_decoder, device="cuda")
        out, enc_ms, dec_ms, launches, peak = timed_serve(cap, imgs)
        steps = greedy_steps(out[0], END_ID)
        name = "int8_decoder" if int8_decoder else "float_decoder"
        k1 = expect_launches(results, "serve_int8_greedy_bf16/" + name,
                             launches, fused_attention=steps, bn_epilogue=0,
                             int8_epilogue=100)["fused_attention"]
        finished = check_greedy(out, IMAGES, max_len, name)
        runs[name] = dict(encoder_ms=enc_ms, decode_ms=dec_ms, steps=steps,
                          k1_launches=k1, finished=finished,
                          captions_per_s=IMAGES / ((enc_ms + dec_ms) / 1e3),
                          peak_memory_bytes=peak)
    # qmatmul's int32 sums at the W8A8 decoder's shapes: LSTM input
    # (embedding and context segments), recurrent, fc; 5 rows; 9,490
    # columns (not a multiple of 8).
    gen = torch.Generator().manual_seed(12)
    shapes = [(IMAGES, EMBED, 4 * DEC_DIM), (IMAGES, ENC_DIM, 4 * DEC_DIM),
              (IMAGES, DEC_DIM, 4 * DEC_DIM), (IMAGES, DEC_DIM, VOCAB),
              (5, DEC_DIM, VOCAB), (IMAGES, DEC_DIM, 9490)]
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen)
        wq, ws = quantize_linear(torch.randn(k, n, generator=gen) * 0.05)
        xq = torch.randint(-127, 128, (m, k), generator=gen,
                           dtype=torch.int8)
        acc = int_mm(xq.cuda(), wq.cuda(), n).cpu()
        check(torch.equal(acc, int_mm(xq, wq, n)), "int_mm card vs CPU",
              (m, k, n))
        check(torch.equal(acc.long(), xq.long() @ wq[:, :n].long()),
              "int_mm vs int64 product", (m, k, n))
        out = qmatmul(x.cuda(), wq.cuda(), ws.cuda()).cpu()
        check(torch.equal(out, qmatmul(x, wq, ws)), "qmatmul card vs CPU",
              (m, k, n))
    log("serve_int8_greedy_bf16", images=IMAGES, max_len=max_len, **runs,
        qmatmul_shapes_equal_to_cpu=shapes, card=card_line())


def phase_serve_int8_beam(models, act_maxes, results):
    import functools

    import torch

    from icd_tpu_torch.decoding.beam import beam_search_batched
    from icd_tpu_torch.decoding.serve import make_beam_captioner
    from icd_tpu_torch.ops.fused_beam import beam_search_fused

    encoder, decoder = models
    imgs = uint8_images(IMAGES, seed=3).cuda()
    loops = (("per_step", beam_search_batched),
             ("fused", beam_search_fused),
             ("per_step_int8_grid",
              functools.partial(beam_search_batched, int8_grid=True)))
    runs, captioners = {}, {}
    for name, beam_fn in loops:
        cap = make_beam_captioner(encoder, decoder, START_ID, END_ID,
                                  beam_size=BEAMS,
                                  compute_dtype=torch.bfloat16,
                                  device="cuda", beam_fn=beam_fn,
                                  act_maxes=act_maxes)
        out, enc_ms, beam_ms, launches, peak = timed_serve(cap, imgs)
        fused = name == "fused"
        expect_launches(results, "serve_int8_beam_bf16/" + name, launches,
                        fused_attention=0 if fused else out["steps"],
                        fused_beam=1 if fused else 0, bn_epilogue=0,
                        int8_epilogue=100)
        k1, k2 = launches["fused_attention"], launches["fused_beam"]
        check(out["seq"].shape == (IMAGES, 52), name + " seq shape")
        check(bool((out["seq"][:, 0] == START_ID).all()),
              name + " seq starts with start")
        check(bool(out["alphas"].isfinite().all()), name + " finite alphas")
        runs[name] = dict(encoder_ms=enc_ms, beam_ms=beam_ms,
                          steps=out["steps"], k1_launches=k1,
                          k2_launches=k2,
                          captions_per_s=IMAGES / ((enc_ms + beam_ms) / 1e3),
                          peak_memory_bytes=peak,
                          found=int(out["found"].sum()))
        captioners[name] = cap
    log("serve_int8_beam_bf16", images=IMAGES, beams=BEAMS, **runs,
        card=card_line())
    return captioners["per_step"]


def baseline_models(models):
    """The baseline model at full width on the card, f32: the ResNet-101 of
    ``full_width_models`` (not a second trunk) with a seeded Linear(2048,
    512) head, and a seeded V=10,000, E=H=512 decoder whose <end> is
    pinned unreachable, as bench.py pins it."""
    import torch

    from icd_tpu_torch import bench
    from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                               init_baseline_decoder)
    from icd_tpu_torch.models.encoder import Encoder, init_embed

    gen = torch.Generator().manual_seed(5)
    embed = init_embed(gen, EMBED, device="cuda")
    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size = VOCAB, EMBED
    params.hidden_size = DEC_DIM
    decoder = init_baseline_decoder(gen, params, device="cuda")
    bench.pin_end(decoder, END_ID)
    return Encoder(models[0].resnet, embed), decoder


def phase_baseline_f32(base, results):
    import torch

    from icd_tpu_torch.decoding.greedy import greedy_decode_baseline
    from icd_tpu_torch.decoding.serve import make_captioner
    from icd_tpu_torch.models.encoder import encoder_forward

    encoder, decoder = base
    max_len = 25
    captioner = make_captioner(encoder, decoder, START_ID, END_ID,
                               max_len=max_len, compute_dtype=torch.float32,
                               device="cuda")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 off for f32")
    imgs = uint8_images(8, seed=2)
    reset_launches()
    feats = captioner.encode(imgs)
    toks = captioner.decode(feats)
    torch.cuda.synchronize()
    expect_launches(results, "baseline_f32", fused_attention=0, fused_beam=0,
                    bn_epilogue=100)
    with torch.inference_mode():
        cpu_feats = encoder_forward(copy.deepcopy(encoder).cpu(), imgs[:1])
        cpu_toks = greedy_decode_baseline(
            copy.deepcopy(decoder).cpu(), feats.cpu(), START_ID, END_ID,
            max_len=max_len)
    check(feats.shape == (8, EMBED) and feats.dtype == torch.float32,
          "f32 features", feats.shape, feats.dtype)
    feat_err = (feats[:1].cpu() - cpu_feats).abs().max().item()
    feat_scale = cpu_feats.abs().max().item()
    # f32 on both sides, different convolution algorithms (path_f32).
    check(feat_err <= 1e-3 * feat_scale, "f32 features vs CPU", feat_err,
          feat_scale)
    check(toks.shape == (8, max_len) and not bool((toks == END_ID).any()),
          "f32 tokens: shape, <end> pinned", toks.shape)
    equal = int((toks.cpu() == cpu_toks).all(dim=1).sum())
    check(equal >= 7, "f32 baseline captions card vs CPU", equal)
    log("baseline_f32", images=8, max_len=max_len, vocab=VOCAB,
        feature_err_vs_cpu=feat_err, feature_max=feat_scale,
        captions_equal_to_cpu=equal, k1_launches=0, k2_launches=0)


def phase_baseline_serve_bf16(base, act_maxes, results):
    import torch

    from icd_tpu_torch.decoding.serve import (make_captioner,
                                              make_int8_captioner)

    encoder, decoder = base
    max_len = 25
    bf16 = torch.bfloat16
    imgs = uint8_images(IMAGES, seed=3).cuda()
    builds = {
        "float": lambda: make_captioner(
            encoder, decoder, START_ID, END_ID, max_len=max_len,
            compute_dtype=bf16, device="cuda"),
        "dynamic_int8": lambda: make_captioner(
            encoder, decoder, START_ID, END_ID, max_len=max_len,
            compute_dtype=bf16, int8=True, device="cuda"),
        "static_int8": lambda: make_int8_captioner(
            encoder, decoder, START_ID, END_ID, max_len=max_len,
            compute_dtype=bf16, act_maxes=act_maxes, device="cuda"),
        "static_int8_w8a8": lambda: make_int8_captioner(
            encoder, decoder, START_ID, END_ID, max_len=max_len,
            compute_dtype=bf16, act_maxes=act_maxes, int8_decoder=True,
            device="cuda"),
    }
    runs = {}
    for name, build in builds.items():
        cap = build()
        toks, enc_ms, dec_ms, launches, peak = timed_serve(cap, imgs)
        # The float trunk (the dynamic int8 path's BN too) launches K3
        # 100 times a batch; the static int8 trunk never.
        expect_launches(results, "baseline_serve_bf16/" + name, launches,
                        fused_attention=0, fused_beam=0,
                        bn_epilogue=0 if name.startswith("static") else 100)
        check(toks.shape == (IMAGES, max_len), name + " token shape",
              toks.shape)
        check(bool(((toks >= 0) & (toks < VOCAB)).all())
              and not bool((toks == END_ID).any()),
              name + " tokens in range, <end> pinned")
        runs[name] = dict(encoder_ms=enc_ms, decode_ms=dec_ms,
                          steps=toks.shape[1],
                          captions_per_s=IMAGES / ((enc_ms + dec_ms) / 1e3),
                          peak_memory_bytes=peak)
        del cap
    log("baseline_serve_bf16", images=IMAGES, max_len=max_len, vocab=VOCAB,
        **runs, card=card_line())


def phase_bench(base, results):
    import torch

    from icd_tpu_torch import bench

    encoder, decoder = base
    imgs = bench.images(bench.BATCH, bench.IMAGE_SIZE, device="cuda")
    for mode in ("int8", "bf16"):
        reset_launches()
        one, result = bench.measure(encoder, decoder, imgs, mode)
        torch.cuda.synchronize()
        expect_launches(results, "bench/" + mode, fused_attention=0,
                        fused_beam=0)
        check(result["value"] > 0 and one["captions_with_end"] == 0
              and one["steps"] == bench.DECODE_LEN
              and one["int8_decoder"] == (mode == "int8"),
              "bench " + mode, one, result)
        print(json.dumps(one), flush=True)
        print(json.dumps(result), flush=True)


BENCH_REPEATS, BENCH_TRIALS = 2, 1  # the benches phase's cut of depth


@contextlib.contextmanager
def k2_first_search(module):
    """Keep the first K2 search that ``module`` runs (its decoder, grid,
    other arguments and output; the search changes none of them) while
    the path runs through the kernel, to hold it against the plain
    version after."""
    kernel = module.beam_search_fused
    seen = []

    def probe(decoder, grid, *args):
        out = kernel(decoder, grid, *args)
        if not seen:
            seen.append((decoder, grid, args, out))
        return out

    module.beam_search_fused = probe
    try:
        yield seen
    finally:
        module.beam_search_fused = kernel


def bench_rows(name, rows, results, labels):
    """Check a bench's rows (labels in its tool's order, positive times)
    and print its last line; returns K1's and K2's launches in its rows
    (K3's and K4's since ``reset_launches``: the rows count K1 and K2
    only), recorded under ``benches/<name>``."""
    import torch

    torch.cuda.synchronize()
    check([r["label"] for r in rows] == list(labels)
          and all(r["ms"] > 0 and math.isfinite(r["rate"]) for r in rows),
          name + " rows", [(r["label"], r["ms"]) for r in rows])
    print(json.dumps(result(name, rows, "cuda")), flush=True)
    counts = dict(launch_counts(),
                  fused_attention=sum(r["k1_launches"] for r in rows),
                  fused_beam=sum(r["k2_launches"] for r in rows))
    expect_launches(results, "benches/" + name, counts)
    return counts["fused_attention"], counts["fused_beam"]


def k2_raw_against_plain(decoder, grid, max_steps, what):
    """One K2 launch and its plain version on the same operands, in f32
    (TF32 off), their raw outputs: the steps equal; step 1's alphas (no
    selection made yet) within phase_k2's 5e-6 on every row; and for at
    least 7/8 of the images every step's parents equal and alphas within
    5e-6. The rest may split: the two sum in other orders (about 1e-6
    apart), and over 64 images x 51 steps x the top-k's ranks a few
    candidates lie that near each other, so rounding orders them
    (k2_trace_splits holds each split to that). Returns (images whose
    history is equal, each split image's first step with other parents,
    the alpha error on equal images, the split images, and the steps
    within which each has split: its first step with other parents, or
    all the steps run)."""
    import torch

    from icd_tpu_torch.ops import fused_beam
    from icd_tpu_torch.testing import f32_products

    f32_products()
    with torch.no_grad():
        ops = fused_beam._operands(decoder, grid)
    raw = fused_beam._launch(ops, BEAMS, START_ID, END_ID, max_steps)
    ref = fused_beam._search_plain(ops, BEAMS, START_ID, END_ID, max_steps)
    steps = raw["steps"]
    check(steps == ref["steps"], what + " steps", steps, ref["steps"])
    rows = slice(1, steps + 1)
    step1 = (raw["alpha"][1] - ref["alpha"][1]).abs().max().item()
    check(step1 <= 5e-6, what + " K2 vs plain, step 1's alphas", step1)
    parents = (raw["parent"][rows].long() == ref["parent"][rows].long()).all(
        dim=2)  # (steps, images)
    alpha_err = (raw["alpha"][rows] - ref["alpha"][rows]).abs().amax(
        dim=(2, 3))
    same = parents.all(dim=0) & (alpha_err <= 5e-6).all(dim=0)
    n = grid.shape[0]
    splits = ((~parents).int().argmax(dim=0) + 1)[~same].tolist()
    check(int(same.sum()) >= n - n // 8, what + " K2 vs plain: images "
          "with equal histories", int(same.sum()), n, splits)
    split_images = torch.nonzero(~same).flatten().tolist()
    within = max((splits[j] if (~parents[:, i]).any() else steps
                  for j, i in enumerate(split_images)), default=0)
    return (int(same.sum()), splits, alpha_err[:, same].max().item(),
            split_images, within)


def k2_trace_splits(decoder, grid, images, steps, what):
    """Trace each image whose K2 history split from the plain version's
    (testing.trace_k2_splits, f32, TF32 off): K2 stopped after each of
    the first ``steps`` steps and read through its workspace views
    (whose parents and alphas must equal the full launch's), the f32
    plain version, and the float64 arbiter on the same beams. One line a
    split: its first step whose choice differs, each pair of candidates
    ranked otherwise (K2's, the plain version's) with their three scores,
    the f64 gap and both versions' errors. Every split must be explained:
    K2's choice the top-k of its own scores at every step up to it, and
    each pair's f64 gap within the two versions' errors together.
    Returns (the number of splits traced, each of them explained, and
    the seconds the trace took)."""
    import torch

    from icd_tpu_torch.ops import fused_beam
    from icd_tpu_torch.testing import f32_products, trace_k2_splits

    f32_products()
    with torch.no_grad():
        ops = fused_beam._operands(decoder, grid)
    t0 = time.perf_counter()
    recs, prefix_equal = trace_k2_splits(ops, BEAMS, START_ID, END_ID,
                                         images, steps)
    seconds = time.perf_counter() - t0
    for rec in recs:
        log("k2_split", what=what, **rec)
    check(prefix_equal, what + " K2 stopped after each step: parents and "
          "alphas equal to the full launch's")
    check(all(r["explained"] for r in recs), what + " K2's splits from "
          "its plain version explained by f32 rounding",
          [(r["image"], r["step"]) for r in recs if not r["explained"]])
    return len(recs), seconds


def phase_benches(models, base, results):
    """Each workload bench's ``measure`` once at full width, with
    BENCH_REPEATS repeats and BENCH_TRIALS trials (the benches run 3
    trials of 4 to 10 repeats: a cut of depth), on this script's models
    where the bench's shapes are theirs. Checks each bench's rows and
    prints its last line; K1 launched on the attention and beam rows,
    K2 once a search on bench_fused_beam's fused row (that row's first
    search held against K2's plain version: in bf16 on the same inputs,
    and on them in f32 by phase_k2's gate, k2_against_plain, and by the
    raw history, k2_raw_against_plain), neither on bench_int8,
    bench_train or bench_bert. Then K2 alone at the 51-step budget (CUDA
    events, L2 emptied, the card asleep while the host sets each launch
    up) beside its bound."""
    import torch

    from icd_tpu_torch import (bench, bench_attention, bench_beam,
                               bench_bert, bench_fused_beam, bench_int8,
                               bench_train)
    from icd_tpu_torch.ops import fused_beam
    from icd_tpu_torch.ops.fused_beam import beam_search_fused_reference

    depth = dict(repeats=BENCH_REPEATS, trials=BENCH_TRIALS, device="cuda")
    imgs = bench.images(IMAGES, 224, "cuda", seed=2)
    seconds, launches = {}, {}

    def run(name, fn, labels):
        reset_launches()
        t0 = time.perf_counter()
        rows = fn()
        seconds[name] = time.perf_counter() - t0
        launches[name] = bench_rows(name, rows, results, labels)
        return rows

    rows = run("bench_int8", lambda: bench_int8.measure(*base, imgs, **depth),
               bench_int8.LABELS)
    check(launches["bench_int8"] == (0, 0)
          and all(r["steps"] == bench_int8.DECODE_LEN for r in rows),
          "bench_int8: no kernel, <end> pinned", launches["bench_int8"])

    pinned = copy.deepcopy(models[1])
    bench.pin_end(pinned, END_ID)
    rows = run("bench_attention", lambda: bench_attention.measure(
        models[0], pinned, imgs, **depth), bench_attention.LABELS)
    for r in rows:
        check(r["steps"] == bench_attention.DECODE_LEN
              and r["k1_launches"] == r["steps"] * r["units"]
              and r["k2_launches"] == 0,
              "bench_attention: K1 once a step", r)
    del pinned

    rows = run("bench_beam", lambda: bench_beam.measure(
        models[0], models[1], imgs, **depth), bench_beam.LABELS)
    for r in rows:
        check(r["k1_launches"] >= min(r["steps"]) * r["units"] > 0
              and r["k2_launches"] == 0, "bench_beam: K1 once a step", r)

    dec16 = bench_fused_beam.decoder("cuda")
    grid = bench_fused_beam.grids(IMAGES, "cuda")
    with k2_first_search(bench_fused_beam) as seen:
        rows = run("bench_fused_beam", lambda: bench_fused_beam.measure(
            dec16, grid, **depth), bench_fused_beam.LABELS)
    fused, *loops = rows
    check(fused["k2_launches"] == fused["units"] and fused["k1_launches"] == 0
          and fused["steps"] == [51], "bench_fused_beam: one K2 launch a "
          "search, 51 steps", fused)
    for r in loops:
        check(r["k1_launches"] == 51 * r["units"] and r["k2_launches"] == 0
              and r["steps"] == [51], "bench_fused_beam: K1 once a step", r)
    dec, first_grid, args, out = seen[0]
    ref = beam_search_fused_reference(dec, first_grid, *args)
    for key in ("seq", "seq_len", "found"):
        check(torch.equal(out[key], ref[key]),
              "bench_fused_beam: first search vs plain, bf16", key)
    dec32, grid32 = copy.deepcopy(dec).float(), first_grid.float()
    k2_against_plain(dec32, grid32, BEAMS, START_ID, END_ID, 51,
                     "bench_fused_beam f32")
    k2_same, k2_splits, k2_err, split_images, within = k2_raw_against_plain(
        dec32, grid32, 51, "bench_fused_beam f32")
    k2_explained, trace_s = k2_trace_splits(
        dec32, grid32, split_images, within, "bench_fused_beam f32")
    del dec32, grid32
    with torch.no_grad():
        ops = fused_beam._operands(dec, first_grid)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    k2_ms = time_ms(lambda: fused_beam._start(ops, BEAMS, START_ID, END_ID,
                                              51),
                    iters=10, flush=flush, settle=True)
    k2_bound, k2_bound_by = fused_beam.bound_ms(ops, BEAMS, 51)
    del dec16, grid, dec, first_grid, ops, flush, seen

    train_imgs = bench.images(TRAIN_BATCH, 224, "cuda", seed=2)
    caps = bench_train.captions(TRAIN_BATCH, TRAIN_LEN, VOCAB, "cuda")
    for name, family, attention in (
            ("bench_train", train_baseline_models(models), False),
            ("bench_train --attention", models, True)):
        run(name, lambda: bench_train.measure(
            *family, train_imgs, caps, attention, **depth),
            bench_train.LABELS)
        check(launches[name] == (0, 0), name + ": no kernel", launches[name])

    vocab, bert, tokenizer = bench_bert.vocab_and_bert()
    decoder = bench_bert.decoder(vocab, BERT_DIM, "cuda")
    run("bench_bert", lambda: bench_bert.measure(
        models[0], decoder, bert, tokenizer, vocab,
        bench_bert.host_batches(len(vocab), BENCH_REPEATS), device="cuda"),
        bench_bert.LABELS)
    check(launches["bench_bert"] == (0, 0), "bench_bert: no kernel",
          launches["bench_bert"])
    log("benches", repeats=BENCH_REPEATS, trials=BENCH_TRIALS,
        seconds=seconds, launches=launches,
        k2_first_search_f32_images_equal_history=k2_same,
        k2_first_search_f32_split_steps=k2_splits,
        k2_first_search_f32_alpha_err_vs_plain=k2_err,
        k2_first_search_f32_splits_explained=k2_explained,
        k2_trace_s=trace_s,
        k2_ms_51_steps=k2_ms, k2_bound_ms_51_steps=k2_bound,
        k2_bound_by=k2_bound_by, k2_share_of_bound=k2_bound / k2_ms)


# Training shapes: tools/bench_train.py:24-26.
TRAIN_BATCH, TRAIN_LEN, TRAIN_BATCHES = 32, 25, 20


def phase_train_step_f32(models, gen, results):
    """One f32 train step (dropout 0, TF32 off) on the card and on the CPU
    from the same parameters, batch 4, caption length 12; the decoder's
    half of the step on both devices from one grid; and both card runs
    again with TF32 on, a fault that the limits must reject."""
    import torch

    from icd_tpu_torch.models.encoder import encoder_attention_forward
    from icd_tpu_torch.testing import (SCORE_BIAS, decoder_grads,
                                       relative_errors, seeded_captions,
                                       train_step_errors, train_step_record)

    encoder, decoder = models
    imgs = uint8_images(4, seed=7)
    captions = seeded_captions(gen, 4, 12, VOCAB, START_ID, END_ID,
                               min_words=4)
    lens = torch.full((4,), 11, dtype=torch.int32)
    lr = 1e-4

    def step(device, tf32=False):
        return train_step_record(encoder, decoder, imgs, captions, lens,
                                 device, lr=lr, tf32=tf32)

    def same_grid(device, tf32=False):
        grads = decoder_grads(decoder, grid, captions, lens, device,
                              tf32=tf32)
        return grads, grads.pop(SCORE_BIAS).abs().max().item()

    reset_launches()
    card = step("cuda")
    with torch.no_grad():
        grid, _ = encoder_attention_forward(encoder, imgs.to("cuda"),
                                             train=True)
    same_card, card_noise = same_grid("cuda")
    torch.cuda.synchronize()
    expect_launches(results, "train_step_f32", fused_attention=0, fused_beam=0,
                    bn_epilogue=0)
    fault, (fault_same, _) = step("cuda", tf32=True), same_grid("cuda", True)
    cpu = step("cpu")
    same_cpu, cpu_noise = same_grid("cpu")

    def readings(run, same):
        errs = train_step_errors(run, cpu, lr)
        errs["grads_same_grid"] = relative_errors(same, same_cpu)
        worst = {key: max(errs[key].values()) for key in (
            "grads", "exp_avg", "exp_avg_sq", "bn", "grads_same_grid")}
        worst.update(loss=errs["loss"],
                     step_share_beyond=errs["step_share_beyond"])
        return errs, worst

    errs, worst = readings(card, same_card)
    _, tf32_worst = readings(fault, fault_same)
    noise = errs["score_bias_grad"] + [card_noise, cpu_noise]
    g_max = max(g.abs().max().item() for g in same_cpu.values())
    # Limits, each between the sound reading and TF32's, which is 4.8 to
    # 6,500 times the limit (PERF.md §6).
    # The f32 grids differ by ~1e-4 of their scale (cuDNN and the CPU
    # sum convolutions in other orders): the loss moves 1.3e-6, and BN's
    # batch statistics 2.6e-5 (channels of tiny variance amplify it).
    # From one grid the decoder's gradients differ only by sums in other
    # orders, 2.1e-6. From each device's own grid an element of
    # relu(att_enc + att_dec) within the grids' difference of zero takes
    # the other branch on the other device; the attention products'
    # gradients are small sums over 4.4 M such elements, so a few flips
    # move them by 4.5 % of their largest value, and Adam's moments
    # with them. A first Adam step moves an element by less than lr on
    # either side; by more than lr / 100 apart only where a gradient
    # element is as small as the devices' difference (7.8e-4 of them).
    limits = dict(loss=1e-5, bn=1e-4, grads_same_grid=1e-5, grads=0.06,
                  exp_avg=0.06, exp_avg_sq=0.06, step_share_beyond=1e-2)
    log("train_step_f32", batch=4, caption_length=12, vocab=VOCAB,
        loss_card=card["loss"], loss_cpu=cpu["loss"], rel_err_max=worst,
        limits=limits, tf32_rel_err_max=tf32_worst,
        grad_rel_err=errs["grads"],
        grad_rel_err_same_grid=errs["grads_same_grid"], grad_max=g_max,
        score_bias_grad=noise, k1_launches=0, k2_launches=0)
    check(math.isfinite(card["loss"]), "train step loss finite",
          card["loss"])
    for key, limit in limits.items():
        check(worst[key] <= limit, "train step {} card vs CPU".format(key),
              worst[key], limit)
    check(all(tf32_worst[key] > limit for key, limit in limits.items()),
          "every limit rejects a TF32 step", tf32_worst)
    check(max(noise) <= 1e-6 * g_max, "score bias gradient is noise", noise)


def train_batches(gen, n, seed):
    """``n`` in-memory batches at the training bench's shapes: seeded uint8
    images and Zipf captions (testing.seeded_captions)."""
    import numpy as np

    from icd_tpu_torch.testing import seeded_captions

    return [dict(imgs=uint8_images(TRAIN_BATCH, seed=seed + i).numpy(),
                 captions=seeded_captions(gen, TRAIN_BATCH, TRAIN_LEN, VOCAB,
                                          START_ID, END_ID).numpy(),
                 padded_lengths=np.full(TRAIN_BATCH, TRAIN_LEN, np.int32))
            for i in range(n)]


def train_readings(run, batches, encode, light_s):
    """common.train_epoch of ``run`` (batch -> loss) over ``batches`` with
    CUDA events around each step, then ``encode`` (the frozen encoder's
    forward) timed alone and one step under torch.profiler. ``light_s``:
    the step's model FLOPs at the row's dense peaks, in seconds."""
    import torch

    from icd_tpu_torch.training.common import train_epoch

    events = []

    def timed(batch):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        loss = run(batch)
        end.record()
        events.append((start, end))
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # earlier phases' models too
    t0 = time.perf_counter()
    losses = train_epoch(timed, batches, print_freq=len(batches))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    step_median = median(step_ms)
    check(len(losses) == len(batches)
          and all(math.isfinite(x) for x in losses), "train losses", losses)
    encoder_ms = time_ms(encode, iters=5, warmup=1)
    _, wall_ms, busy_ms, kernels = profiled(lambda: run(batches[0]))
    return dict(
        median_step_ms=step_median,
        step_ms_min_max=[step_ms[0], step_ms[-1]],
        images_per_s=TRAIN_BATCH / (step_median / 1e3), epoch_s=epoch_s,
        epoch_images_per_s=TRAIN_BATCH * len(batches) / epoch_s,
        encoder_forward_ms=encoder_ms,
        decoder_fwd_bwd_adam_ms=step_median - encoder_ms,
        profiled_step_wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
        idle_share_of_median_step=1 - busy_ms / step_median,
        peak_memory_bytes=peak, resident_before_bytes=resident,
        peak_share=light_s / (step_median / 1e3),
        losses=[losses[0], losses[-1]],
        top=[dict(name=name[:60], ms=us / 1e3, count=count)
             for us, count, name in kernels[:8]])


def learns(trainer, batch, what):
    """30 steps of a fresh ``trainer`` (decoder_lr 1e-3) on one batch: the
    loss must fall below 0.8x its first value."""
    import torch

    learn = torch.stack([trainer(batch) for _ in range(30)]).tolist()
    check(all(math.isfinite(x) for x in learn)
          and learn[-1] < 0.8 * learn[0],
          what + ": 30 steps on one batch, the loss falls below 0.8x", learn)
    return [learn[0], learn[-1]]


def attention_trainer(models, decoder_lr, compute_dtype=None):
    """A fresh copy of the attention model and its train step on a batch
    (dropout 0.5, grad_clip 5, Adam), and the copy's encoder."""
    import torch

    from icd_tpu_torch.training.attention import batch_step, make_train_step
    from icd_tpu_torch.training.common import (make_optimizer,
                                               trainable_parameters)

    enc, dec = (copy.deepcopy(m) for m in models)
    enc_params, dec_params = trainable_parameters(enc, dec)
    optimizer = make_optimizer(enc_params, dec_params, 1e-4, decoder_lr)
    step = make_train_step(enc, dec, optimizer, 1.0, 0.5, 5.0, compute_dtype)
    dropout_gen = torch.Generator("cuda").manual_seed(1)
    run = batch_step(step, "cuda", dropout_gen)
    run.optimizer = optimizer
    return run, enc, dec


def phase_train_f32(models, gen, results):
    """train_epoch over 20 in-memory batches at the training bench's
    shapes, dropout 0.5, grad_clip 5; then 30 steps on one batch at
    decoder_lr 1e-3. Returns the trained (encoder, decoder)."""
    import torch

    from icd_tpu_torch.data.pipeline import to_device
    from icd_tpu_torch.models.encoder import encoder_attention_forward

    batches = train_batches(gen, TRAIN_BATCHES, seed=100)
    run, enc, dec = attention_trainer(models, 1e-4)
    imgs = to_device(batches[0]["imgs"], "cuda")

    def encode():
        with torch.no_grad():
            encoder_attention_forward(enc, imgs, train=True)

    gflop = (TRAIN_BATCH * RESNET101_GFLOP
             + decoder_train_gflops(True, b=TRAIN_BATCH, t=TRAIN_LEN))
    reset_launches()
    row = train_readings(run, batches, encode, gflop * 1e9 / F32_FLOP_PER_S)
    expect_launches(results, "train_f32", fused_attention=0, fused_beam=0,
                    bn_epilogue=0)
    learn = learns(attention_trainer(models, 1e-3)[0], batches[0],
                   "train_f32")
    row["f32_peak_share"] = row.pop("peak_share")
    log("train_f32", batch=TRAIN_BATCH, caption_length=TRAIN_LEN,
        vocab=VOCAB, batches=TRAIN_BATCHES, dropout=0.5,
        model_gflop_per_step=gflop, learn_first_last=learn, **row,
        card=card_line())
    return enc, dec


def phase_eval_f32(trained, gen, results):
    """make_eval_step over 130 items in batches of 64, the last of 2 at
    its own size as ``evaluate`` runs it, f32; every item against the
    CPU run of the same batches; the first batch again with TF32 on, a
    fault the loss limit must reject; the scorers on the host."""
    import numpy as np
    import torch

    from icd_tpu_torch.data.pipeline import to_device
    from icd_tpu_torch.metric import get_eval_score
    from icd_tpu_torch.testing import f32_products, seeded_captions
    from icd_tpu_torch.training.attention import (make_eval_step,
                                                  scoring_texts)

    n, batch = 130, 64
    imgs = uint8_images(n, seed=11).numpy()
    captions = seeded_captions(gen, n, 20, VOCAB, START_ID, END_ID,
                               min_words=3).numpy()
    lengths = (captions != 0).sum(1).astype(np.int32)
    batches = [tuple(a[i:i + batch] for a in (imgs, captions, lengths - 1))
               for i in range(0, n, batch)]
    step = make_eval_step(*trained)
    f32_products()
    reset_launches()
    losses, preds = [], []
    t0 = time.perf_counter()
    for b in batches:
        loss, pred = step(*(to_device(a, "cuda") for a in b))
        losses.append(loss.cpu())
        preds.append(pred.cpu())
    eval_s = time.perf_counter() - t0
    expect_launches(results, "eval_f32", fused_attention=0, fused_beam=0,
                    bn_epilogue=300)
    losses, preds = torch.cat(losses), torch.cat(preds)
    check(losses.shape == (n,) and preds.shape == (n, 19)
          and bool(losses.isfinite().all()), "eval shapes", losses.shape,
          preds.shape)

    cpu_step = make_eval_step(*(copy.deepcopy(m).cpu() for m in trained))
    t0 = time.perf_counter()
    cpu = [cpu_step(*(torch.from_numpy(a) for a in b)) for b in batches]
    cpu_s = time.perf_counter() - t0
    cpu_loss = torch.cat([loss for loss, _ in cpu])
    cpu_pred = torch.cat([pred for _, pred in cpu])
    loss_err = ((losses - cpu_loss).abs() / cpu_loss.abs()).max().item()
    mask = np.arange(19)[None, :] < (lengths - 1)[:, None]
    same = float((preds == cpu_pred).numpy()[mask].mean())
    f32_products(tf32=True)
    tf32_loss, _ = step(*(to_device(a, "cuda") for a in batches[0]))
    f32_products()
    tf32_err = ((tf32_loss.cpu() - cpu_loss[:batch]).abs()
                / cpu_loss[:batch].abs()).max().item()
    os.environ.setdefault("ICD_TPU_METEOR_PY", "1")
    refs, hyps = scoring_texts(preds.numpy(), captions, lengths,
                               {START_ID, END_ID, 0})
    scores = get_eval_score(refs, hyps)
    log("eval_f32", items=n, batch=batch, seconds=eval_s, cpu_seconds=cpu_s,
        loss_mean=losses.mean().item(), loss_rel_err_vs_cpu=loss_err,
        tf32_loss_rel_err_vs_cpu=tf32_err, preds_equal_share_vs_cpu=same,
        scores=scores, k1_launches=0, k2_launches=0)
    # The losses inherit the f32 grids' card-vs-CPU difference as the
    # train step's loss does (3.2e-6); TF32 must land beyond the limit
    # (1.8e-3).
    # An argmax can flip only where the top two logits are closer than
    # the devices' difference.
    check(loss_err <= 1e-5 < tf32_err, "eval losses card vs CPU, TF32",
          loss_err, tf32_err)
    check(same >= 0.99, "eval argmax card vs CPU", same)
    check(all(math.isfinite(v) and v >= 0 for v in scores.values()),
          "eval scores", scores)


def train_baseline_models(models):
    """The baseline model to train: full_width_models' ResNet-101 (its BN
    re-estimated; the trainers copy it) with a seeded Linear(2048, 512)
    head and a seeded V=10,000, E=H=512 decoder, f32 on the card, <end>
    not pinned (the captions end with it)."""
    import torch

    from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                               init_baseline_decoder)
    from icd_tpu_torch.models.encoder import Encoder, init_embed

    gen = torch.Generator().manual_seed(13)
    embed = init_embed(gen, EMBED, device="cuda")
    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size = VOCAB, EMBED
    params.hidden_size = DEC_DIM
    decoder = init_baseline_decoder(gen, params, device="cuda")
    return Encoder(models[0].resnet, embed), decoder


def baseline_trainer(base, decoder_lr, compute_dtype=None, warm=None):
    """A fresh copy of the baseline model and its train step on a batch
    (grad_clip 5, Adam, the head frozen as by default); with ``warm``
    (batches) its trunk is warmed up and quantized for --int8_encoder.
    Returns (step, encoder, decoder, int8 trunk or None)."""
    from icd_tpu_torch.training.baseline import batch_step, make_train_step
    from icd_tpu_torch.training.common import (make_optimizer,
                                               prepare_int8_encoder,
                                               trainable_parameters)

    enc, dec = (copy.deepcopy(m) for m in base)
    qresnet = None
    if warm is not None:
        qresnet = prepare_int8_encoder(enc.resnet, warm, compute_dtype)
    enc_params, dec_params = trainable_parameters(enc, dec)
    optimizer = make_optimizer(enc_params, dec_params, 1e-4, decoder_lr)
    step = make_train_step(enc, dec, optimizer, 0, 5.0, compute_dtype,
                           qresnet)
    return batch_step(step, "cuda"), enc, dec, qresnet


def worst_errors(run, want, lr, extra=()):
    """train_step_errors of ``run`` against ``want``, each table's largest
    entry, beside the loss's and the share beyond lr / 100."""
    from icd_tpu_torch.testing import train_step_errors

    errs = train_step_errors(run, want, lr)
    worst = {key: max(errs[key].values())
             for key in ("grads", "exp_avg", "exp_avg_sq", "bn") + extra}
    worst.update(loss=errs["loss"],
                 step_share_beyond=errs["step_share_beyond"])
    return errs, worst


def phase_train_baseline_step_f32(base, gen, results):
    """One f32 baseline step (TF32 off, head trained) on the card and on
    the CPU from the same parameters, batch 4, caption length 12; the
    card's again with TF32 on, a fault that every limit must reject."""
    import torch

    from icd_tpu_torch.testing import seeded_captions, train_step_record

    imgs = uint8_images(4, seed=12)
    captions = seeded_captions(gen, 4, 12, VOCAB, START_ID, END_ID,
                               min_words=4)
    lr = 1e-4

    def step(device, tf32=False):
        return train_step_record(*base, imgs, captions, None, device, lr=lr,
                                 tf32=tf32)

    reset_launches()
    card = step("cuda")
    torch.cuda.synchronize()
    expect_launches(results, "train_baseline_step_f32", fused_attention=0,
                    fused_beam=0, bn_epilogue=0)
    fault = step("cuda", tf32=True)
    cpu = step("cpu")
    errs, worst = worst_errors(card, cpu, lr)
    _, tf32_worst = worst_errors(fault, cpu, lr)
    check({"embed.weight", "embed.bias"} <= set(card["grads"]),
          "the head trains", sorted(card["grads"]))
    # Limits, each between the sound reading and TF32's (PERF.md §6): the
    # features differ by ~1e-4 of their scale (cuDNN and the CPU sum the
    # trunk's convolutions in other orders) and the LSTM has no kink, so
    # gradients and Adam's moments move by 0.9e-4 to 1.7e-4, BN's
    # statistics by 2.8e-5, and 8.7e-5 of the updated elements land more
    # than lr / 100 apart; TF32 moves them by 5.4e-2, 9.1e-2, 1.5e-2 and
    # 1.6e-2. The random decoder's logits are small and its loss sits at
    # log V: the f32 and the TF32 step give the card's loss equal to the
    # CPU's, so the loss is held to its limit but cannot tell TF32 apart.
    limits = dict(loss=1e-5, bn=1e-4, grads=1e-3, exp_avg=1e-3,
                  exp_avg_sq=1e-3, step_share_beyond=1e-3)
    log("train_baseline_step_f32", batch=4, caption_length=12, vocab=VOCAB,
        loss_card=card["loss"], loss_cpu=cpu["loss"], rel_err_max=worst,
        limits=limits, tf32_rel_err_max=tf32_worst,
        grad_rel_err=errs["grads"], k1_launches=0, k2_launches=0)
    check(math.isfinite(card["loss"]), "baseline step loss finite",
          card["loss"])
    for key, limit in limits.items():
        check(worst[key] <= limit,
              "baseline step {} card vs CPU".format(key), worst[key], limit)
    check(all(tf32_worst[key] > limit for key, limit in limits.items()
              if key != "loss"),
          "every limit but the loss's rejects a TF32 baseline step",
          tf32_worst)


def phase_train_baseline(base, gen, results):
    """The training bench's baseline workload (batch 32, caption length
    25, V = 10,000), 20 in-memory steps in each of its rows: f32, amp
    and amp + int8 encoder; then 30 steps on one batch in f32 and in amp.
    Returns the f32 row's trained (encoder, decoder)."""
    import torch

    from icd_tpu_torch.data.pipeline import to_device
    from icd_tpu_torch.models.encoder import (encoder_forward,
                                              encoder_forward_int8)

    bf16 = torch.bfloat16
    batches = train_batches(gen, TRAIN_BATCHES, seed=200)
    imgs = to_device(batches[0]["imgs"], "cuda")
    trunk = TRAIN_BATCH * RESNET101_GFLOP
    dec_gflop = decoder_train_gflops(False, b=TRAIN_BATCH, t=TRAIN_LEN)
    rows, trained = {}, None
    for name, dtype, int8, trunk_peak, dec_peak in (
            ("f32", None, False, F32_FLOP_PER_S, F32_FLOP_PER_S),
            ("amp", bf16, False, BF16_FLOP_PER_S, BF16_FLOP_PER_S),
            ("amp_int8", bf16, True, INT8_OP_PER_S, BF16_FLOP_PER_S)):
        run, enc, dec, qresnet = baseline_trainer(
            base, 1e-4, dtype, batches if int8 else None)

        def encode():
            with torch.no_grad():
                if qresnet is None:
                    encoder_forward(enc, imgs, compute_dtype=dtype,
                                    train=True)
                else:
                    encoder_forward_int8(enc, qresnet, imgs, dtype)

        reset_launches()
        rows[name] = train_readings(
            run, batches, encode,
            trunk * 1e9 / trunk_peak + dec_gflop * 1e9 / dec_peak)
        expect_launches(results, "train_baseline/" + name, fused_attention=0,
                        fused_beam=0, bn_epilogue=None if int8 else 0)
        if trained is None:
            trained = (enc, dec)
    learn = {name: learns(baseline_trainer(base, 1e-3, dtype)[0],
                          batches[0], "train_baseline " + name)
             for name, dtype in (("f32", None), ("amp", bf16))}
    log("train_baseline", batch=TRAIN_BATCH, caption_length=TRAIN_LEN,
        vocab=VOCAB, batches=TRAIN_BATCHES, model_gflop_per_step=trunk
        + dec_gflop, **rows, learn_first_last=learn, card=card_line())
    return trained


def phase_train_amp_step(models, base, gen, results):
    """One --amp step of each family on the card and on the CPU from the
    same parameters (batch 4, caption length 12, dropout 0); then 20
    attention --amp steps at train_f32's shapes."""
    import torch

    from icd_tpu_torch.data.pipeline import to_device
    from icd_tpu_torch.models.encoder import encoder_attention_forward
    from icd_tpu_torch.testing import seeded_captions, train_step_record

    bf16 = torch.bfloat16
    imgs = uint8_images(4, seed=14)
    captions = seeded_captions(gen, 4, 12, VOCAB, START_ID, END_ID,
                               min_words=4)
    lens = torch.full((4,), 11, dtype=torch.int32)
    lr = 1e-4
    # bf16 roundings land differently on the two devices (cuBLAS and
    # cuDNN against the CPU's kernels): the limits of
    # tests/test_torch_cuda.py's amp step, but for BN's statistics, which
    # are taken from bf16 activations whose roundings compound through
    # the 104 BN layers of ResNet-101: 3.0e-2 apart at full depth
    # (PERF.md §6), 1e-1 allowed.
    limits = dict(loss=1e-2, bn=1e-1, step_share_beyond=0.1)
    steps = {}
    for family, (encoder, decoder), dl in (("baseline", base, None),
                                           ("attention", models, lens)):
        reset_launches()
        card = train_step_record(encoder, decoder, imgs, captions, dl, "cuda",
                                 lr=lr, compute_dtype=bf16)
        torch.cuda.synchronize()
        expect_launches(results, "train_amp_step/" + family, fused_attention=0,
                        fused_beam=0, bn_epilogue=0)
        cpu = train_step_record(encoder, decoder, imgs, captions, dl, "cpu",
                                lr=lr, compute_dtype=bf16)
        _, worst = worst_errors(card, cpu, lr)
        steps[family] = dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
                             rel_err_max=worst)
        check(math.isfinite(card["loss"]), family + " amp loss finite")
        for key, limit in limits.items():
            check(worst[key] <= limit, "{} amp step {} card vs CPU".format(
                family, key), worst[key], limit)
        for key in ("params", "exp_avg", "exp_avg_sq", "bn"):
            check(all(t.dtype == torch.float32 for t in card[key].values()),
                  family + " amp: f32 " + key)
        start = dict(list(encoder.named_parameters())
                     + list(decoder.named_parameters()))
        same = all(torch.equal(v, start[n].detach().cpu())
                   for n, v in card["frozen"].items())
        check(same, family + " amp: frozen weights bit-identical")
        before = dict(encoder.named_buffers())
        check(any(not torch.equal(v, before[n].cpu())
                  for n, v in card["bn"].items()),
              family + " amp: BN statistics updated")

    batches = train_batches(gen, TRAIN_BATCHES, seed=400)
    run, enc, _ = attention_trainer(models, 1e-4, bf16)
    first = to_device(batches[0]["imgs"], "cuda")

    def encode():
        with torch.no_grad():
            encoder_attention_forward(enc, first, compute_dtype=bf16,
                                      train=True)

    gflop = (TRAIN_BATCH * RESNET101_GFLOP
             + decoder_train_gflops(True, b=TRAIN_BATCH, t=TRAIN_LEN))
    reset_launches()
    row = train_readings(run, batches, encode,
                         gflop * 1e9 / BF16_FLOP_PER_S)
    expect_launches(results, "train_amp_step/attention_steps",
                    fused_attention=0, fused_beam=0, bn_epilogue=0)
    log("train_amp_step", batch=4, caption_length=12, vocab=VOCAB,
        limits=limits, **steps, attention_amp=dict(
            batch=TRAIN_BATCH, caption_length=TRAIN_LEN,
            batches=TRAIN_BATCHES, dropout=0.5,
            model_gflop_per_step=gflop, **row),
        k1_launches=0, k2_launches=0, card=card_line())


def site_act_maxes(qresnet):
    """Each site's calibrated act_max (127 / inv_in), in call order."""
    import numpy as np

    sites = [qresnet["stem"]] + [
        block[k] for blocks in qresnet["layers"] for block in blocks
        for k in ("conv1", "conv2", "conv3", "downsample") if k in block]
    return np.array([127.0 / float(site["inv_in"]) for site in sites])


def phase_train_int8_step(models, base, gen, results):
    """--int8_encoder on the card and on the CPU: warm-up (16 batches of 4
    images, f32 train-mode BN) and f32 calibration of the shared trunk on
    each device; then one int8 step of each family from the card's int8
    tree on both devices."""
    import numpy as np
    import torch

    from icd_tpu_torch.models.encoder import Encoder, EncoderAttention
    from icd_tpu_torch.testing import (relative_errors, seeded_captions,
                                       train_step_record)
    from icd_tpu_torch.training.common import (INT8_BN_WARMUP_BATCHES,
                                               prepare_int8_encoder)

    warm = [dict(imgs=uint8_images(4, seed=300 + i).numpy())
            for i in range(INT8_BN_WARMUP_BATCHES)]
    prepared = {}
    for device in ("cuda", "cpu"):
        reset_launches()
        resnet = copy.deepcopy(models[0].resnet).to(device)
        t0 = time.perf_counter()
        qresnet = prepare_int8_encoder(resnet, warm, None)
        prepared[device] = (resnet, qresnet, time.perf_counter() - t0)
        expect_launches(results, "train_int8_step/prepare_" + device,
                        fused_attention=0, fused_beam=0)
    stats = relative_errors(
        dict(prepared["cuda"][0].named_buffers()),
        {n: b.to("cuda") for n, b in prepared["cpu"][0].named_buffers()})
    act_max = {d: site_act_maxes(p[1]) for d, p in prepared.items()}
    act_err = float(np.max(np.abs(act_max["cuda"] - act_max["cpu"])
                           / act_max["cpu"]))
    imgs = uint8_images(4, seed=16)
    captions = seeded_captions(gen, 4, 12, VOCAB, START_ID, END_ID,
                               min_words=4)
    lens = torch.full((4,), 11, dtype=torch.int32)
    resnet, qresnet, _ = prepared["cuda"]
    warmed = {n: b.cpu() for n, b in resnet.named_buffers()}
    steps = {}
    for family, encoder, decoder, dl in (
            ("baseline", Encoder(resnet, base[0].embed), base[1], None),
            ("attention", EncoderAttention(resnet), models[1], lens)):
        reset_launches()
        card = train_step_record(encoder, decoder, imgs, captions, dl, "cuda",
                                 lr=1e-4, qresnet=qresnet)
        torch.cuda.synchronize()
        expect_launches(results, "train_int8_step/" + family,
                        fused_attention=0, fused_beam=0)
        cpu = train_step_record(encoder, decoder, imgs, captions, dl, "cpu",
                                lr=1e-4, qresnet=qresnet)
        loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        unchanged = all(torch.equal(run["bn"]["resnet." + n], b)
                        for run in (card, cpu) for n, b in warmed.items())
        steps[family] = dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
                             loss_rel_err=loss_err,
                             bn_unchanged=unchanged)
        # The int32 sums and the f32 epilogue are the same on both
        # devices; only the decoder's f32 sums run in other orders.
        check(loss_err <= 1e-5, family + " int8 step loss card vs CPU",
              loss_err)
        check(unchanged, family + " int8 step: BN statistics unchanged")
    log("train_int8_step", warmup_batches=len(warm), warmup_batch=4,
        prepare_s={d: p[2] for d, p in prepared.items()},
        warmed_bn_rel_err_max=max(stats.values()),
        act_max_rel_err_max=act_err, **steps, k1_launches=0, k2_launches=0)
    # The warm-up's 16 f32 train-mode steps on each device: BN statistics
    # move by the convolutions' sums in other orders (one step: 2.6e-5,
    # PR 7), and so do the calibrated ranges.
    check(max(stats.values()) <= 1e-3, "warmed BN statistics card vs CPU",
          max(stats.values()))
    check(act_err <= 1e-3, "calibrated act_maxes card vs CPU", act_err)


def phase_eval_baseline_f32(trained, gen, results):
    """The baseline's make_eval_step over 130 items in batches of 64 (the
    last, of 2, at its own size, as evaluate runs it), f32; every item
    against the CPU run of the same batches; the first batch again with
    TF32 on, a fault the loss limit must reject; the scorers on the
    host."""
    import numpy as np
    import torch

    from icd_tpu_torch.data.pipeline import to_device
    from icd_tpu_torch.metric import get_eval_score
    from icd_tpu_torch.testing import f32_products, seeded_captions
    from icd_tpu_torch.training.baseline import make_eval_step, scoring_texts

    n, batch = 130, 64
    imgs = uint8_images(n, seed=17).numpy()
    captions = seeded_captions(gen, n, 20, VOCAB, START_ID, END_ID,
                               min_words=3).numpy()
    lengths = (captions != 0).sum(1).astype(np.int32)
    batches = [tuple(a[i:i + batch] for a in (imgs, captions, lengths))
               for i in range(0, n, batch)]
    step = make_eval_step(*trained)
    f32_products()
    reset_launches()
    losses, preds = [], []
    t0 = time.perf_counter()
    for b in batches:
        loss, pred = step(*(to_device(a, "cuda") for a in b))
        losses.append(loss.cpu())
        preds.append(pred.cpu())
    eval_s = time.perf_counter() - t0
    expect_launches(results, "eval_baseline_f32", fused_attention=0,
                    fused_beam=0, bn_epilogue=300)
    losses, preds = torch.cat(losses), torch.cat(preds)
    check(losses.shape == (n,) and preds.shape == (n, 20)
          and bool(losses.isfinite().all()), "baseline eval shapes",
          losses.shape, preds.shape)

    cpu_step = make_eval_step(*(copy.deepcopy(m).cpu() for m in trained))
    t0 = time.perf_counter()
    cpu = [cpu_step(*(torch.from_numpy(a) for a in b)) for b in batches]
    cpu_s = time.perf_counter() - t0
    cpu_loss = torch.cat([loss for loss, _ in cpu])
    cpu_pred = torch.cat([pred for _, pred in cpu])
    loss_err = ((losses - cpu_loss).abs() / cpu_loss.abs()).max().item()
    mask = np.arange(20)[None, :] < lengths[:, None]
    same = float((preds == cpu_pred).numpy()[mask].mean())
    f32_products(tf32=True)
    tf32_loss, _ = step(*(to_device(a, "cuda") for a in batches[0]))
    f32_products()
    tf32_err = ((tf32_loss.cpu() - cpu_loss[:batch]).abs()
                / cpu_loss[:batch].abs()).max().item()
    os.environ.setdefault("ICD_TPU_METEOR_PY", "1")
    refs, hyps = scoring_texts(preds.numpy(), captions, lengths,
                               {START_ID, END_ID, 0})
    scores = get_eval_score(refs, hyps)
    log("eval_baseline_f32", items=n, batch=batch, seconds=eval_s,
        cpu_seconds=cpu_s, loss_mean=losses.mean().item(),
        loss_rel_err_vs_cpu=loss_err, tf32_loss_rel_err_vs_cpu=tf32_err,
        preds_equal_share_vs_cpu=same, scores=scores, k1_launches=0,
        k2_launches=0)
    # As eval_f32: the features' card-vs-CPU difference moves the losses
    # below the limit, TF32 beyond it; an argmax flips only where the top
    # two logits are closer than the devices' difference.
    check(loss_err <= 1e-5 < tf32_err, "baseline eval losses card vs CPU, "
          "TF32", loss_err, tf32_err)
    check(same >= 0.99, "baseline eval argmax card vs CPU", same)
    check(all(math.isfinite(v) and v >= 0 for v in scores.values()),
          "baseline eval scores", scores)


BERT_CAPTIONS, BERT_DIM = 32, 768


def bert_vocab():
    """The smoke's caption vocabulary (V = 10,000: <pad> 0, 9,996 seeded
    words of 2 to 10 letters, <start>, <end>, <unk>) and a bert-base
    vocab.txt made from it as tools/make_tiny_bert.py makes one (the
    special pieces, < and >, then the words lower-cased without < and
    >), except that every other word of more than 3 letters is split into
    its first 3 letters and a ## continuation, so that WordPiece joins
    pieces; filled with [unused] entries to bert-base's 30,522. Returns
    (vocab, path)."""
    import numpy as np

    from icd_tpu_torch.models.bert import BERT_BASE
    from icd_tpu_torch.vocabulary import (END_TOKEN, PAD_TOKEN, START_TOKEN,
                                          UNK_TOKEN, Vocabulary)

    rng = np.random.default_rng(17)
    words = []
    seen = set()
    while len(words) < VOCAB - 4:
        n = int(rng.integers(2, 11))
        word = "".join(chr(97 + c) for c in rng.integers(0, 26, n))
        if word not in seen:
            seen.add(word)
            words.append(word)
    vocab = Vocabulary()
    for word in [PAD_TOKEN] + words + [START_TOKEN, END_TOKEN, UNK_TOKEN]:
        vocab.add_word(word)
    check(vocab(START_TOKEN) == START_ID and vocab(END_TOKEN) == END_ID,
          "smoke vocabulary ids")
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "<", ">",
              "start", "end", "pad", "unk"]
    for i, word in enumerate(words):
        pieces += ([word[:3], "##" + word[3:]] if i % 2 and len(word) > 3
                   else [word])
    pieces = list(dict.fromkeys(pieces))
    pieces += ["[unused{}]".format(i)
               for i in range(BERT_BASE["vocab_size"] - len(pieces))]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "bert_vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(pieces))
    return vocab, path


def bert_forward_gflop(mask, layers=12, hidden=768, inter=3072):
    """Model GFLOP that one bert-base forward needs over the rows of
    ``mask`` (B, L): per valid piece and layer the q, k, v, o and FFN
    products, and per row of n valid pieces the attention's two (n, n)
    products; padded pieces and keys count nothing."""
    import numpy as np

    n = np.asarray(mask).sum(1).astype(np.float64)
    per_token = 2 * (4 * hidden * hidden + 2 * hidden * inter)
    attn = 2 * 2 * hidden
    return layers * float((n * per_token + n * n * attn).sum()) / 1e9


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def bert_models(models):
    """The --use_bert attention model at full width: full_width_models'
    ResNet-101 and a seeded V=10,000 decoder with A = H = 512 and
    E = 768 (BERT's width), f32 on the card."""
    import torch

    from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                                init_attention_decoder)

    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim = ATT_DIM, DEC_DIM
    params.embed_size, params.vocab = BERT_DIM, range(VOCAB)
    params.use_bert = True
    decoder = init_attention_decoder(torch.Generator().manual_seed(23),
                                     params, device="cuda")
    return models[0], decoder


def phase_bert_f32(gen, results):
    """bert-base at its published geometry (12 layers, hidden 768, 12
    heads, FFN 3,072, 30,522 pieces, 512 positions) with weights from a
    seeded generator, f32, TF32 off: the embedder's device path on the
    card against the same embedder on the CPU over 32 seeded captions of
    8 to 25 words, padded (the train form) and cut to their lengths (the
    eval form); the card's run again with TF32 on must fail the limit.
    Times the forward and the host's tokenization. Returns (bert on the
    CPU, tokenizer, vocabulary)."""
    import numpy as np
    import torch

    from icd_tpu_torch.models.bert import (BERT_BASE, bert_aligned_forward,
                                           init_bert)
    from icd_tpu_torch.models.bert_embed import (BertCaptionEmbedder,
                                                 caption_keys)
    from icd_tpu_torch.models.bert_tokenize import BertTokenizer
    from icd_tpu_torch.testing import f32_products, seeded_captions

    vocab, path = bert_vocab()
    tokenizer = BertTokenizer(path)
    t0 = time.perf_counter()
    bert = init_bert(torch.Generator().manual_seed(21), BERT_BASE, "cpu")
    init_s = time.perf_counter() - t0
    captions = seeded_captions(gen, BERT_CAPTIONS, 27, VOCAB, START_ID,
                               END_ID, min_words=8).numpy()
    lengths = (captions != 0).sum(1)
    f32_products()
    card = BertCaptionEmbedder(vocab, model=copy.deepcopy(bert),
                               tokenizer=tokenizer, device="cuda")
    cpu = BertCaptionEmbedder(vocab, model=bert, tokenizer=tokenizer,
                              device="cpu")
    keys = caption_keys(captions)
    t0 = time.perf_counter()
    card.piece_arrays(captions, keys)
    cold_ms = (time.perf_counter() - t0) * 1e3
    card._cache.clear()
    t0 = time.perf_counter()
    ids, mask, seg, n_words = card.piece_arrays(captions, keys)
    warm_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    got = card(captions).cpu()
    got_len = card(captions, lengths=lengths).cpu()
    torch.cuda.synchronize()
    expect_launches(results, "bert_f32", fused_attention=0, fused_beam=0,
                    bn_epilogue=0)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want = cpu(captions)
    want_len = cpu(captions, lengths=lengths)
    cpu_s = time.perf_counter() - t0
    f32_products(tf32=True)
    fault = card(captions).cpu()
    f32_products()
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
           for a in (ids, mask, seg)]
    model = card.bert.bert
    with torch.no_grad():
        forward_ms = time_ms(lambda: bert_aligned_forward(model, *dev,
                                                          n_words),
                             iters=10, warmup=2)
    gflop = bert_forward_gflop(mask)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    bound_ms, _ = roofline_ms(weight_bytes, gflop * 1e9, F32_FLOP_PER_S)
    errs = dict(aligned=rel_err(got, want), lengths=rel_err(got_len,
                                                            want_len))
    tf32_err = rel_err(fault, want)
    # 12 layers of f32 sums in other orders: 1.0e-6 to 1.2e-6 of the
    # largest value on the H100 (PERF.md §6); TF32 4.9e-4 to 5.3e-4.
    limit = 1e-5
    log("bert_f32", captions=BERT_CAPTIONS, pieces=list(ids.shape),
        pieces_valid=int(mask.sum()), words=n_words,
        init_cpu_s=init_s, forward_ms=forward_ms, model_gflop=gflop,
        bound_ms=bound_ms, tokenize_cold_ms=cold_ms, tokenize_warm_ms=warm_ms,
        peak_memory_bytes=peak, resident_before_bytes=resident,
        cpu_seconds=cpu_s, rel_err_vs_cpu=errs, limit=limit,
        tf32_rel_err_vs_cpu=tf32_err, k1_launches=0, k2_launches=0)
    check(got.shape == (BERT_CAPTIONS, 28, BERT_DIM)
          and bool(torch.isfinite(got).all()), "bert shapes", got.shape)
    for row, n in zip(got_len, lengths):
        check(not row[n + 1:].any(), "rows past a caption are zero")
    check(max(errs.values()) <= limit < tf32_err,
          "bert card vs CPU, TF32", errs, tf32_err)
    return bert, tokenizer, vocab


def phase_bert_int8(bert, tokenizer, vocab, gen, results):
    """The W8A8 BERT (ops/qlinear.py products; attention products, tables
    and LayerNorms f32) on the card and on the CPU, 8 captions. With the
    CPU's int8 inputs shared (testing.SharedQuantization): the int32 sums
    of every product of every layer equal, each product's float input
    and the output within the limit of the CPU's; the card's run again
    with TF32 on and the attention's operands rounded to TF32 must fail
    it. Free-running, the output error card vs
    CPU is printed, and the CPU's W8A8 output is held to the quality
    bound against its f32 forward. Its forward ms beside the f32 one's on
    the smoke's 32 captions."""
    import numpy as np
    import torch

    from icd_tpu_torch.models.bert import (bert_encoder_forward,
                                           quantize_bert)
    from icd_tpu_torch.models.bert_embed import (BertCaptionEmbedder,
                                                 caption_keys)
    from icd_tpu_torch.testing import (SharedQuantization, f32_products,
                                       seeded_captions, tf32_operands)

    f32_products()
    captions = seeded_captions(gen, BERT_CAPTIONS, 27, VOCAB, START_ID,
                               END_ID, min_words=8).numpy()
    card = BertCaptionEmbedder(vocab, model=copy.deepcopy(bert),
                               tokenizer=tokenizer, device="cuda", int8=True)
    ids, mask, seg, n_words = card.piece_arrays(captions,
                                                caption_keys(captions))
    qcpu = quantize_bert(bert)
    qcard = card.bert.bert
    few = [torch.from_numpy(np.ascontiguousarray(a[:8])).long()
           for a in (ids, mask)]
    valid = few[1].bool()
    shared = SharedQuantization()
    with torch.no_grad():
        reset_launches()
        q_card = bert_encoder_forward(qcard, *(t.cuda() for t in few)).cpu()
        torch.cuda.synchronize()
        expect_launches(results, "bert_int8", fused_attention=0, fused_beam=0,
                        bn_epilogue=0)
        with shared.applied():
            q_cpu = bert_encoder_forward(qcpu, *few)
        readings = {}
        for run in ("f32", "tf32", "tf32_operands"):
            f32_products(tf32=run != "f32")
            with shared.applied(), (tf32_operands() if run == "tf32_operands"
                                    else contextlib.nullcontext()):
                out = bert_encoder_forward(qcard,
                                           *(t.cuda() for t in few)).cpu()
            output_err = rel_err(out[valid], q_cpu[valid])
            readings[run] = dict(
                sums_equal=shared.sums_equal, input_err=shared.input_err,
                output_err=output_err,
                float_err=max(shared.input_err, output_err))
        f32_products()
        f32_cpu = bert_encoder_forward(bert, *few)
        free_err = rel_err(q_card[valid], q_cpu[valid])
        vs_f32 = rel_err(q_cpu[valid], f32_cpu[valid])
        dev = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
               for a in (ids, mask)]
        f32_model = copy.deepcopy(bert).cuda()
        int8_ms = time_ms(lambda: bert_encoder_forward(qcard, *dev),
                          iters=10, warmup=2)
        f32_ms = time_ms(lambda: bert_encoder_forward(f32_model, *dev),
                         iters=10, warmup=2)
    del f32_model
    shared_run, tf32_run = readings["f32"], readings["tf32_operands"]
    # With the int8 inputs shared, the two forwards differ by their f32
    # work only (sums in other orders, as bert_f32: ~1e-6 of the largest
    # value), read at every product's float input and at the output. The
    # only f32 products left are the attention's, which cuBLAS runs on
    # TF32 tensor cores in some runs and not in others (the TF32 mode
    # alone read 1.5e-4 in one run, bit-identical to f32 in another,
    # PERF.md §6): the control rounds their operands to TF32 itself
    # (testing.tf32_operands), which shows at the o products' inputs (the
    # output, past the shared int8 rows, does not see it). Free-running,
    # an activation that rounds to the other int8 value on the two devices
    # moves the next product by a quantization step and 12 layers carry it
    # on (2.1e-2 to 2.3e-2 apart at the output, PERF.md §6): printed, not
    # gated, since TF32 hides under it. 0.05 is the W8A8 quality bound of
    # tests/test_bert_jax.py, on the CPU alone.
    limit, quality = 1e-5, 0.05
    log("bert_int8", captions=8, timed_captions=BERT_CAPTIONS,
        products=len(shared.records), shared=shared_run, limit=limit,
        tf32_mode_shared=readings["tf32"], tf32_operands_shared=tf32_run,
        free_running_rel_err_vs_cpu=free_err,
        int8_vs_f32_rel_err=vs_f32, quality_bound=quality,
        int8_forward_ms=int8_ms, f32_forward_ms=f32_ms, k1_launches=0,
        k2_launches=0)
    check(len(shared.records) == 6 * len(qcpu.layers),
          "bert int8: every product recorded", len(shared.records))
    check(all(r["sums_equal"] for r in readings.values()),
          "bert int8: every product's int32 sums card == CPU")
    check(bool(torch.isfinite(q_card).all()), "bert int8 finite")
    check(shared_run["float_err"] <= limit < tf32_run["float_err"],
          "bert int8 products' inputs and output card vs CPU, TF32 operands",
          shared_run, tf32_run)
    check(vs_f32 <= quality, "bert int8 against f32", vs_f32, quality)


def bert_trainer(models, embedder, decoder_lr):
    """A fresh copy of the --use_bert attention model and its train step on
    a batch: BERT's embeddings of the batch's captions made first (on the
    card, as ``training.attention.train`` makes them), dropout 0.5,
    grad_clip 5, Adam, the table frozen. Returns (run, encoder,
    decoder)."""
    import torch

    from icd_tpu_torch.training.attention import (batch_step,
                                                  make_train_step,
                                                  with_bert)
    from icd_tpu_torch.training.common import (make_optimizer,
                                               trainable_parameters)

    enc, dec = (copy.deepcopy(m) for m in models)
    enc_params, dec_params = trainable_parameters(enc, dec)
    optimizer = make_optimizer(enc_params, dec_params, 1e-4, decoder_lr)
    step = make_train_step(enc, dec, optimizer, 1.0, 0.5, 5.0)
    run = batch_step(step, "cuda", torch.Generator("cuda").manual_seed(1))
    prepare = with_bert(embedder)
    return (lambda batch: run(prepare(dict(batch)))), enc, dec


def phase_train_bert_step_f32(bmodels, bert, tokenizer, vocab, gen,
                              results):
    """One f32 --use_bert step (dropout 0, TF32 off) at batch 4, caption
    length 12, on the card and on the CPU from the same parameters and
    the same BERT embeddings, with train_step_f32's limits, the one-grid
    gradients taken with the CPU's relu branches; the decoder's table
    bit-identical after the step; the card's step again with TF32 on
    must fail every limit."""
    import torch

    from icd_tpu_torch.models.bert_embed import BertCaptionEmbedder
    from icd_tpu_torch.models.encoder import encoder_attention_forward
    from icd_tpu_torch.testing import (SCORE_BIAS, ReluBranches,
                                       decoder_grads, relative_errors,
                                       seeded_captions, train_step_errors,
                                       train_step_record)

    encoder, decoder = bmodels
    imgs = uint8_images(4, seed=19)
    captions = seeded_captions(gen, 4, 12, VOCAB, START_ID, END_ID,
                               min_words=4)
    lens = torch.full((4,), 11, dtype=torch.int32)
    emb = BertCaptionEmbedder(vocab, model=bert, tokenizer=tokenizer,
                              device="cpu")(captions.numpy())
    lr = 1e-4

    def step(device, tf32=False):
        return train_step_record(encoder, decoder, imgs, captions, lens,
                                 device, lr=lr, tf32=tf32, embeddings=emb)

    # The CPU's relu branches, recorded by its one-grid run and taken by
    # the card's.
    branches = ReluBranches()

    def same_grid(device, tf32=False):
        grads = decoder_grads(decoder, grid, captions, lens, device,
                              tf32=tf32, embeddings=emb, branches=branches)
        return grads, grads.pop(SCORE_BIAS).abs().max().item()

    with torch.no_grad():
        grid, _ = encoder_attention_forward(encoder, imgs.to("cuda"),
                                            train=True)
    same_cpu, cpu_noise = same_grid("cpu")
    reset_launches()
    card = step("cuda")
    same_card, card_noise = same_grid("cuda")
    flipped = branches.flipped
    torch.cuda.synchronize()
    expect_launches(results, "train_bert_step_f32", fused_attention=0,
                    fused_beam=0, bn_epilogue=0)
    fault, (fault_same, _) = step("cuda", tf32=True), same_grid("cuda", True)
    tf32_flipped = branches.flipped
    cpu = step("cpu")

    def readings(run, same):
        errs = train_step_errors(run, cpu, lr)
        errs["grads_same_grid"] = relative_errors(same, same_cpu)
        worst = {key: max(errs[key].values()) for key in (
            "grads", "exp_avg", "exp_avg_sq", "bn", "grads_same_grid")}
        worst.update(loss=errs["loss"],
                     step_share_beyond=errs["step_share_beyond"])
        return errs, worst

    errs, worst = readings(card, same_card)
    _, tf32_worst = readings(fault, fault_same)
    noise = errs["score_bias_grad"] + [card_noise, cpu_noise]
    g_max = max(g.abs().max().item() for g in same_cpu.values())
    table = decoder.embedding.weight.detach().cpu()
    frozen = all(torch.equal(r["frozen"]["embedding.weight"], table)
                 for r in (card, fault, cpu))
    # train_step_f32's limits (the decoder reads BERT's embeddings in
    # place of its table, the rest of the step is the same), but for the
    # gradients and moments through each device's own grid: relu elements
    # at the kink take the other branch there, and this E = 768 decoder's
    # attention products moved by 6.5e-2 to 8.5e-2 of their largest value
    # (PERF.md §6; TF32 0.71 to 1.09), so 0.1. From one grid, att_enc and
    # att_dec still round differently on the two devices, ~1e-7 of their
    # scale, so an element of relu(att_enc + att_dec) that close to zero
    # (of 4.4 M a step) would take the other branch and move a row of
    # enc_att's and dec_att's gradients whole (3.7e-2 of the largest
    # value, PERF.md §6); with the CPU's branches taken on the card too
    # (``flipped`` counts the elements whose own sign disagreed), the
    # gradients differ by the f32 work only: 1e-4.
    limits = dict(loss=1e-5, bn=1e-4, grads_same_grid=1e-4, grads=0.1,
                  exp_avg=0.1, exp_avg_sq=0.1, step_share_beyond=1e-2)
    log("train_bert_step_f32", batch=4, caption_length=12, vocab=VOCAB,
        embed=BERT_DIM, loss_card=card["loss"], loss_cpu=cpu["loss"],
        rel_err_max=worst, limits=limits, tf32_rel_err_max=tf32_worst,
        grad_rel_err_same_grid=errs["grads_same_grid"],
        relu_elements_flipped=flipped, tf32_relu_elements_flipped=tf32_flipped,
        grad_max=g_max, score_bias_grad=noise, table_bit_identical=frozen,
        k1_launches=0, k2_launches=0)
    check(math.isfinite(card["loss"]), "bert step loss finite", card["loss"])
    check(frozen and "embedding.weight" not in card["grads"],
          "bert step: the decoder's table frozen")
    for key, limit in limits.items():
        check(worst[key] <= limit,
              "bert step {} card vs CPU".format(key), worst[key], limit)
    check(all(tf32_worst[key] > limit for key, limit in limits.items()),
          "every limit rejects a TF32 bert step", tf32_worst)
    check(max(noise) <= 1e-6 * g_max, "bert score bias gradient is noise",
          noise)


def phase_train_bert(bmodels, bert, tokenizer, vocab, gen, results):
    """20 --use_bert steps at the training bench's shapes (batch 32,
    caption length 25, V = 10,000, dropout 0.5), each batch's embeddings
    made by the card's BERT within the step; then 30 steps on one batch
    at decoder_lr 1e-3, whose loss must fall below 0.8x. Returns the
    trained (encoder, decoder) and the card's embedder."""
    import torch

    from icd_tpu_torch.data.pipeline import to_device
    from icd_tpu_torch.models.bert_embed import (BertCaptionEmbedder,
                                                 caption_keys)
    from icd_tpu_torch.models.encoder import encoder_attention_forward

    embedder = BertCaptionEmbedder(vocab, model=copy.deepcopy(bert),
                                   tokenizer=tokenizer, device="cuda")
    batches = train_batches(gen, TRAIN_BATCHES, seed=500)
    run, enc, dec = bert_trainer(bmodels, embedder, 1e-4)
    imgs = to_device(batches[0]["imgs"], "cuda")

    def encode():
        with torch.no_grad():
            encoder_attention_forward(enc, imgs, train=True)

    captions = batches[0]["captions"]
    pieces = embedder.piece_arrays(captions, caption_keys(captions))[1]
    bert_gflop = bert_forward_gflop(pieces)
    gflop = (TRAIN_BATCH * RESNET101_GFLOP + bert_gflop
             + decoder_train_gflops(True, e=BERT_DIM, b=TRAIN_BATCH,
                                   t=TRAIN_LEN))
    reset_launches()
    row = train_readings(run, batches, encode, gflop * 1e9 / F32_FLOP_PER_S)
    expect_launches(results, "train_bert", fused_attention=0, fused_beam=0,
                    bn_epilogue=0)
    bert_ms = time_ms(lambda: embedder(batches[0]["captions"]), iters=10,
                      warmup=2)
    learn = learns(bert_trainer(bmodels, embedder, 1e-3)[0], batches[0],
                   "train_bert")
    row["f32_peak_share"] = row.pop("peak_share")
    log("train_bert", batch=TRAIN_BATCH, caption_length=TRAIN_LEN,
        vocab=VOCAB, embed=BERT_DIM, batches=TRAIN_BATCHES, dropout=0.5,
        pieces=list(pieces.shape), bert_ms=bert_ms,
        bert_share_of_step=bert_ms / row["median_step_ms"],
        model_gflop_per_step=gflop, bert_gflop=bert_gflop,
        learn_first_last=learn, **row, card=card_line())
    return enc, dec


def phase_eval_bert_f32(trained, bert, tokenizer, vocab, gen, results):
    """make_eval_step with BERT's embeddings over 130 items in batches of
    64 (the last, of 2, at its own size), f32: the embeddings of each
    caption cut to its length (the eval form), made once on the card and
    given to both devices; every item's loss and prediction against the
    CPU's; the first batch again with TF32 on must fail the loss
    limit."""
    import numpy as np
    import torch

    from icd_tpu_torch.data.pipeline import to_device
    from icd_tpu_torch.models.bert_embed import BertCaptionEmbedder
    from icd_tpu_torch.testing import f32_products, seeded_captions
    from icd_tpu_torch.training.attention import make_eval_step

    n, batch = 130, 64
    imgs = uint8_images(n, seed=23).numpy()
    captions = seeded_captions(gen, n, 20, VOCAB, START_ID, END_ID,
                               min_words=3).numpy()
    lengths = (captions != 0).sum(1).astype(np.int32)
    embedder = BertCaptionEmbedder(vocab, model=copy.deepcopy(bert),
                                   tokenizer=tokenizer, device="cuda")
    f32_products()
    batches = []
    for i in range(0, n, batch):
        emb = embedder(captions[i:i + batch], lengths=lengths[i:i + batch])
        batches.append((imgs[i:i + batch], captions[i:i + batch],
                        lengths[i:i + batch] - 1, emb))
    step = make_eval_step(*trained)
    reset_launches()
    losses, preds = [], []
    t0 = time.perf_counter()
    for im, cap, dl, emb in batches:
        loss, pred = step(to_device(im, "cuda"), to_device(cap, "cuda"),
                          to_device(dl, "cuda"), emb)
        losses.append(loss.cpu())
        preds.append(pred.cpu())
    eval_s = time.perf_counter() - t0
    expect_launches(results, "eval_bert_f32", fused_attention=0, fused_beam=0,
                    bn_epilogue=300)
    losses, preds = torch.cat(losses), torch.cat(preds)
    check(losses.shape == (n,) and preds.shape == (n, 19)
          and bool(losses.isfinite().all()), "bert eval shapes",
          losses.shape, preds.shape)
    cpu_step = make_eval_step(*(copy.deepcopy(m).cpu() for m in trained))
    t0 = time.perf_counter()
    cpu = [cpu_step(*(torch.from_numpy(a) for a in (im, cap, dl)), emb.cpu())
           for im, cap, dl, emb in batches]
    cpu_s = time.perf_counter() - t0
    cpu_loss = torch.cat([loss for loss, _ in cpu])
    cpu_pred = torch.cat([pred for _, pred in cpu])
    loss_err = ((losses - cpu_loss).abs() / cpu_loss.abs()).max().item()
    mask = np.arange(19)[None, :] < (lengths - 1)[:, None]
    same = float((preds == cpu_pred).numpy()[mask].mean())
    im, cap, dl, emb = batches[0]
    f32_products(tf32=True)
    tf32_loss, _ = step(to_device(im, "cuda"), to_device(cap, "cuda"),
                        to_device(dl, "cuda"), emb)
    f32_products()
    tf32_err = ((tf32_loss.cpu() - cpu_loss[:batch]).abs()
                / cpu_loss[:batch].abs()).max().item()
    log("eval_bert_f32", items=n, batch=batch, seconds=eval_s,
        cpu_seconds=cpu_s, loss_mean=losses.mean().item(),
        loss_rel_err_vs_cpu=loss_err, tf32_loss_rel_err_vs_cpu=tf32_err,
        preds_equal_share_vs_cpu=same, k1_launches=0, k2_launches=0)
    # As eval_f32: the grids' card-vs-CPU difference moves the losses
    # below the limit, TF32 beyond it.
    check(loss_err <= 1e-5 < tf32_err, "bert eval losses card vs CPU, TF32",
          loss_err, tf32_err)
    check(same == 1.0, "bert eval argmax card == CPU", same)


# ---------------------------------------------------------------------------
# The multi-chip path (mesh_nccl1, mesh_gloo_shared)
# ---------------------------------------------------------------------------

MESH_STEPS, MESH_LR = 3, 1e-4
MESH_DIR = os.path.join(BUILD_DIR, "mesh")
SCORE_BIAS_KEY = ("attention", "full_att", "b")


def mesh_models(models):
    """The models the mesh phases train: the attention model of
    full_width_models and the baseline model of train_baseline_models."""
    return {"attention": models, "baseline": train_baseline_models(models)}


def tree_leaves(tree, prefix=()):
    """{path: array} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(tree_leaves(value, prefix + (key,)))
        return out
    return {prefix: tree}


def mesh_errors(got, want, lr):
    """How far one testing.mesh_train result is from another: the losses'
    largest relative error; over the decoder's tensors the largest
    max |d| / max |want| of the parameters and of Adam's mu and nu, and
    the share of parameter elements more than lr / 100 apart (the score
    bias, zero in exact arithmetic, left out of all but the share)."""
    import numpy as np

    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(
        got["losses"], want["losses"]))}
    for key, tree in (("params", "decoder"), ("mu", "mu"), ("nu", "nu")):
        g = tree_leaves(got[tree] if tree == "decoder" else got["adam"][tree])
        w = tree_leaves(want[tree] if tree == "decoder"
                        else want["adam"][tree])
        out[key] = max(float(np.abs(g[k] - w[k]).max())
                       / max(float(np.abs(w[k]).max()), 1e-30)
                       for k in w if k[-3:] != SCORE_BIAS_KEY)
    g, w = tree_leaves(got["decoder"]), tree_leaves(want["decoder"])
    out["share_beyond"] = (sum(int((np.abs(g[k] - w[k]) > lr / 100).sum())
                               for k in w)
                           / sum(w[k].size for k in w))
    return out


def mesh_step_ms(family, fam_models, batch, mesh, rounds=5):
    """Median ms (CUDA events around each) of f32 steps of fresh copies
    of ``family`` on ``batch`` (the train loop's batch_step), on
    ``mesh`` and with none, in turns (mesh, none, none, mesh) for
    ``rounds`` rounds after one warm-up step each: (mesh ms, no-mesh
    ms)."""
    import types

    import torch

    from icd_tpu_torch.training import attention, baseline
    from icd_tpu_torch.training.common import make_adam

    def runner(on):
        enc, dec = (copy.deepcopy(m) for m in fam_models)
        args = types.SimpleNamespace(encoder_lr=MESH_LR, decoder_lr=MESH_LR,
                                     fine_tune_embedding=True,
                                     use_bert=False)
        optimizer = make_adam(args, enc, dec, None, mesh=on)
        if family == "baseline":
            return baseline.batch_step(baseline.make_train_step(
                enc, dec, optimizer, 0, 5.0, mesh=on), "cuda", on)
        return attention.batch_step(attention.make_train_step(
            enc, dec, optimizer, 1.0, 0.0, 5.0, mesh=on), "cuda", None, on)

    runs = {"mesh": runner(mesh), "none": runner(None)}
    times = {"mesh": [], "none": []}
    for run in runs.values():
        run(batch)
    for _ in range(rounds):
        for key in ("mesh", "none", "none", "mesh"):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            runs[key](batch)
            end.record()
            times[key].append((start, end))
    torch.cuda.synchronize()
    return tuple(sorted(s.elapsed_time(e) for s, e in times[key])[rounds]
                 for key in ("mesh", "none"))


@contextlib.contextmanager
def k1_first_call():
    """Keep K1's first call on the decode path (inputs, keywords,
    outputs) while the path runs through the kernel, to hold it against
    the plain version after."""
    import icd_tpu_torch.models.attention as attention

    kernel = attention.fused_attention
    seen = []

    def probe(*args, **kw):
        out = kernel(*args, **kw)
        if not seen:
            seen.append(([a.clone() for a in args], kw,
                         [o.clone() for o in out]))
        return out

    attention.fused_attention = probe
    try:
        yield seen
    finally:
        attention.fused_attention = kernel


def k1_call_errors(seen):
    """K1's recorded bf16 call against its plain version in f32 on the
    same inputs, with phase_k1's bf16 limits: (ctx error, alpha error)."""
    import torch

    from icd_tpu_torch.ops.fused_attention import fused_attention_reference

    args, kw, (ctx, alpha) = seen[0]
    ref_ctx, ref_alpha = fused_attention_reference(
        *(t.float() for t in args), **kw)
    err = (ctx.float() - ref_ctx).abs()
    check(bool((err <= 2 ** -8 * ref_ctx.abs() + 1e-5).all()),
          "mesh K1 vs plain: bf16 ctx error", err.max().item())
    alpha_err = (alpha - ref_alpha).abs().max().item()
    check(alpha_err <= 1e-5, "mesh K1 vs plain: alpha error", alpha_err)
    torch.cuda.synchronize()
    return err.max().item(), alpha_err


def mesh_captions(mesh, models, imgs, probe=False):
    """The sharded greedy and per-step beam captioners of the attention
    model on ``mesh`` at bf16 over ``imgs``: tokens, beam outputs, each
    kernel's launches on each path (``launches``: greedy's, beam's; the
    beam's K2 checked to be 0) and, with ``probe``, K1's first call held
    against its plain version."""
    import torch

    from icd_tpu_torch.decoding.serve import (
        make_sharded_attention_captioner, make_sharded_beam_captioner)

    encoder, decoder = models
    greedy = make_sharded_attention_captioner(encoder, decoder, START_ID,
                                              END_ID, mesh)
    beam = make_sharded_beam_captioner(encoder, decoder, START_ID, END_ID,
                                       mesh, beam_size=BEAMS)
    greedy(imgs[:8])
    beam(imgs[:8])  # warm-up: kernel load, cuDNN plans
    reset_launches()
    with k1_first_call() as seen:
        toks, _ = greedy(imgs)
    torch.cuda.synchronize()
    on_greedy = launch_counts()
    k1_errs = k1_call_errors(seen) if probe else None
    reset_launches()
    out = beam(imgs)
    torch.cuda.synchronize()
    on_beam = launch_counts()
    check(on_beam["fused_beam"] == 0, "sharded beam launched K2",
          on_beam["fused_beam"])
    return dict(greedy=greedy, beam=beam, toks=toks.cpu(),
                seq=out["seq"].cpu(), seq_len=out["seq_len"].cpu(),
                found=out["found"].cpu(), steps=out["steps"],
                launches=(on_greedy, on_beam),
                k1_greedy=on_greedy["fused_attention"],
                k1_beam=on_beam["fused_attention"], k1_errs=k1_errs)


def phase_mesh_nccl1(models, gen, results):
    """A one-rank NCCL group in this process and a (1, 1) mesh on it: the
    f32 steps of both families through the mesh path against the same
    steps without a mesh; the step's ms beside the unsharded step's; the
    sharded captioners at batch 64 bf16 against the one-card captioners
    they wrap. Writes the models, the batches and this run's results
    under build/mesh for mesh_gloo_shared."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from icd_tpu_torch.parallel import make_mesh
    from icd_tpu_torch.parallel.mesh import TIMEOUT
    from icd_tpu_torch.testing import f32_products, mesh_train

    f32_products()
    os.makedirs(MESH_DIR, exist_ok=True)
    fams = mesh_models(models)
    batches = train_batches(gen, MESH_STEPS, seed=300)
    imgs = uint8_images(IMAGES, seed=12).cuda()
    tmp = tempfile.mkdtemp(prefix="icd_nccl1_")
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=0, world_size=1, timeout=TIMEOUT,
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, 1, device="cuda")
        runs, fields = {}, {}
        reset_launches()
        for family, fam_models in fams.items():
            meshed = mesh_train(mesh, family, *(copy.deepcopy(m)
                                                for m in fam_models),
                                batches, lr=MESH_LR)
            plain = mesh_train(None, family, *(copy.deepcopy(m)
                                               for m in fam_models),
                               batches, lr=MESH_LR)
            errs = mesh_errors(meshed, plain, MESH_LR)
            leaves = [(tree_leaves(meshed[k]), tree_leaves(plain[k]))
                      for k in ("decoder", "adam", "bn")]
            bit_equal = meshed["losses"] == plain["losses"] and all(
                (g[k] == w[k]).all() for g, w in leaves for k in w)
            ms = mesh_step_ms(family, fam_models, batches[0], mesh)
            fields[family] = dict(losses=meshed["losses"],
                                  rel_err_vs_no_mesh=errs,
                                  bit_equal=bit_equal, step_ms=ms[0],
                                  no_mesh_step_ms=ms[1],
                                  mesh_cost_ms=ms[0] - ms[1])
            check(bit_equal, "mesh_nccl1 {}: one-rank mesh steps bit-equal "
                  "to no mesh".format(family), errs)
            runs[family] = meshed
        expect_launches(results, "mesh_nccl1_train", fused_attention=0,
                        fused_beam=0, bn_epilogue=0)
        caps = mesh_captions(mesh, models, imgs, probe=True)
        # The one-card captioners the sharded ones wrap, on the batch.
        toks, _ = caps["greedy"].captioner(imgs)
        ref = caps["beam"].captioner(imgs)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp)
    check(torch.equal(caps["toks"], toks.cpu()), "mesh_nccl1 greedy tokens")
    for key in ("seq", "seq_len", "found"):
        check(torch.equal(caps[key], ref[key].cpu()),
              "mesh_nccl1 beam " + key)
    check(caps["steps"] == ref["steps"], "mesh_nccl1 beam steps")
    steps = greedy_steps(caps["toks"], END_ID)
    on_greedy, on_beam = caps["launches"]
    expect_launches(results, "mesh_nccl1_greedy", on_greedy,
                    fused_attention=steps)
    expect_launches(results, "mesh_nccl1_beam", on_beam,
                    fused_attention=caps["steps"])
    expect_launches(results, "mesh_nccl1_serve", {
        name: on_greedy[name] + on_beam[name] for name in KERNELS},
        fused_beam=0)
    torch.save(dict(models=fams, batches=batches, imgs=imgs.cpu()),
               os.path.join(MESH_DIR, "models.pt"))
    torch.save(dict(runs=runs, toks=caps["toks"], seq=caps["seq"]),
               os.path.join(MESH_DIR, "reference.pt"))
    log("mesh_nccl1", backend="nccl", mesh=[1, 1], batch=TRAIN_BATCH,
        caption_length=TRAIN_LEN, steps=MESH_STEPS, lr=MESH_LR,
        families=fields, serve_batch=IMAGES, greedy_steps=steps,
        beam_steps=caps["steps"], k1_launches=dict(
            greedy=caps["k1_greedy"], beam=caps["k1_beam"]),
        k1_vs_plain=dict(ctx_err=caps["k1_errs"][0],
                         alpha_err=caps["k1_errs"][1]),
        k2_launches=0)


@contextlib.contextmanager
def library_collectives(n_model):
    """A deliberate fault: the vocab-parallel gather's and sum's backward
    as ``torch.distributed.nn``'s all_gather and all_reduce give it, the
    gradient summed over the model group, which for the replicated loss
    is n_model times each shard's gradient."""
    from icd_tpu_torch.parallel import vocab

    gather, total = vocab._GatherVocab.backward, vocab._SumOverModel.backward

    def scaled(fn):
        return staticmethod(lambda ctx, grad: tuple(
            g * n_model if g is not None else None for g in fn(ctx, grad)))

    vocab._GatherVocab.backward = scaled(gather)
    vocab._SumOverModel.backward = scaled(total)
    try:
        yield
    finally:
        vocab._GatherVocab.backward = staticmethod(gather)
        vocab._SumOverModel.backward = staticmethod(total)


def mesh_gloo_rank(rank, world, mesh_dir):
    """One of mesh_gloo_shared's ranks: a (2, 2) mesh over gloo, the four
    ranks on the one card (or over NCCL, one card a rank: --nccl4). Runs
    both families' steps clean, with TF32 on and with the n_model-times
    gradient fault; rank 0 measures each against mesh_nccl1's one-rank
    run. Then the sharded captioners at batch 64, rank 0 holding K1's
    first call against its plain version and the tokens against one
    rank's."""
    import torch

    from icd_tpu_torch.decoding.serve import make_sharded_attention_captioner
    from icd_tpu_torch.parallel import make_mesh
    from icd_tpu_torch.testing import f32_products, mesh_train

    device = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(os.path.join(mesh_dir, "models.pt"),
                       map_location=device, weights_only=False)
    ref = (torch.load(os.path.join(mesh_dir, "reference.pt"),
                      weights_only=False) if rank == 0 else None)
    imgs = saved["imgs"].to(device)
    mesh = make_mesh(2, 2, device=device)
    out = {"errors": {}, "train_s": {}}
    faults = {"clean": contextlib.nullcontext,
              "tf32": contextlib.nullcontext,
              "n_model": lambda: library_collectives(2)}
    reset_launches()
    for family, fam_models in saved["models"].items():
        for fault, context in faults.items():
            f32_products(tf32=fault == "tf32")
            t0 = time.perf_counter()
            with context():
                got = mesh_train(mesh, family, *(copy.deepcopy(m)
                                                 for m in fam_models),
                                 saved["batches"], lr=MESH_LR)
            torch.cuda.synchronize()
            out["train_s"]["{}_{}".format(family, fault)] = (
                time.perf_counter() - t0)
            if rank == 0:
                out["errors"]["{}_{}".format(family, fault)] = mesh_errors(
                    got, ref["runs"][family], MESH_LR)
    out["train_launches"] = launch_counts()
    f32_products()
    t0 = time.perf_counter()
    caps = mesh_captions(mesh, saved["models"]["attention"], imgs,
                         probe=rank == 0)
    out["serve_s"] = time.perf_counter() - t0
    out.update({k: caps[k] for k in ("launches", "k1_greedy", "k1_beam",
                                     "steps", "k1_errs")})
    # The same greedy captioner in f32 (TF32 off), where a batch of 32
    # and one of 64 round alike.
    f32 = make_sharded_attention_captioner(
        *saved["models"]["attention"], START_ID, END_ID, mesh,
        compute_dtype=torch.float32)
    toks32 = f32(imgs)[0].cpu()
    if rank == 0:
        out["f32_greedy_equal_one_card"] = int(
            (toks32 == f32.captioner(imgs)[0].cpu()).all(1).sum())
        # The one-card captioner on each data rank's rows, and one rank's
        # tokens of the whole batch (mesh_nccl1).
        half = IMAGES // 2
        per_shard = torch.cat([caps["greedy"].captioner(
            imgs[d * half:(d + 1) * half])[0].cpu() for d in range(2)])
        out["greedy_equal_per_shard"] = bool(torch.equal(caps["toks"],
                                                         per_shard))
        out["greedy_equal_one_rank"] = int(
            (caps["toks"] == ref["toks"]).all(1).sum())
        out["one_card_batch64_equal_one_rank"] = int(
            (caps["greedy"].captioner(imgs)[0].cpu() == ref["toks"]).all(1)
            .sum())
        out["beam_equal_one_rank"] = int(
            (caps["seq"] == ref["seq"]).all(1).sum())
    return out


# mesh_gloo_shared's limits against mesh_nccl1's one-rank run after
# MESH_STEPS steps, each between the clean reading and a fault's (TF32 on,
# or the vocab-parallel backward summed over the model group: n_model
# times the gradient), as PERF.md §6 records them. The data ranks' BN
# sums are taken in another order, so the grids differ in their last
# bits: the baseline's loss by ~1e-7, its Adam moments by ~1e-5; in the
# attention model relu elements within that of zero flip, moving the
# attention products' gradients and moments by ~1 % (PRs 7-9). Adam
# turns last-bit gradient differences near its eps into up to 1e-2 of a
# step, and the fc bias starts at zero, so the attention parameters are
# held by the share of elements more than lr / 100 apart, not by their
# largest difference.
MESH_LIMITS = {
    "attention": dict(loss=1e-4, share_beyond=0.05, mu=0.1, nu=0.1),
    "baseline": dict(loss=1e-6, params=3e-3, share_beyond=1e-3, mu=1e-4,
                     nu=1e-4)}


def phase_mesh_gloo_shared(results, backend="gloo"):
    """Four gloo ranks spawned on the one card, a (2, 2) mesh: three f32
    steps of each family against mesh_nccl1's one-rank run (the limits
    above, each of which TF32 or the n_model-times gradient fault must
    exceed), and the sharded captioners at batch 64 bf16. A correctness
    run, not a scaling figure: the four ranks share one card. With
    ``backend`` "nccl" (``python3 chip_smoke.py --nccl4``) the same ranks
    run over NCCL, rank r on card r, and the line is mesh_nccl4's."""
    from icd_tpu_torch.parallel import run_ranks

    phase = "mesh_gloo_shared" if backend == "gloo" else "mesh_nccl4"
    t0 = time.perf_counter()
    outs = run_ranks(mesh_gloo_rank, 4, args=(MESH_DIR,), backend=backend,
                     device="cuda:0", limit_s=600)
    wall_s = time.perf_counter() - t0
    first = outs[0]
    errors = first["errors"]
    log(phase, backend=backend, ranks=4, mesh=[2, 2],
        note=("four ranks sharing one card: a correctness run, not a "
              "scaling figure" if backend == "gloo" else
              "four cards, one a rank: a correctness run"),
        wall_s=wall_s, errors=errors,
        train_s=first["train_s"], serve_s=first["serve_s"],
        k1_launches=dict(greedy=[o["k1_greedy"] for o in outs],
                         beam=[o["k1_beam"] for o in outs]),
        beam_steps=[o["steps"] for o in outs],
        k1_vs_plain=first["k1_errs"],
        greedy_equal_per_shard=first["greedy_equal_per_shard"],
        greedy_equal_one_rank=first["greedy_equal_one_rank"],
        beam_equal_one_rank=first["beam_equal_one_rank"],
        one_card_batch64_equal_one_rank=first[
            "one_card_batch64_equal_one_rank"],
        f32_greedy_equal_one_card=first["f32_greedy_equal_one_card"],
        limits=MESH_LIMITS, k2_launches=0)
    for family, limits in MESH_LIMITS.items():
        clean = errors[family + "_clean"]
        faults = [errors[family + "_tf32"], errors[family + "_n_model"]]
        for key, limit in limits.items():
            check(clean[key] <= limit, "{} {} {} vs the one-rank run"
                  .format(phase, family, key), clean[key], limit)
            check(any(f[key] > limit for f in faults), "{} {} {}: TF32 or "
                  "the n_model-times gradient exceeds the limit".format(
                      phase, family, key), [f[key] for f in faults], limit)
    check(not any(n for o in outs for n in o["train_launches"].values()),
          phase + ": the train steps launched a kernel",
          [o["train_launches"] for o in outs])
    check(all(o["k1_greedy"] > 0 and o["k1_beam"] > 0 for o in outs),
          phase + ": K1 launched on every rank")
    check(first["greedy_equal_per_shard"],
          phase + ": gathered greedy tokens")
    # In f32 a data rank's batch of 32 and one card's batch of 64 give the
    # same tokens (64 of 64 in every run so far); two are allowed to split on
    # a near tie of two logits within the kernels' last bits. In bf16 the
    # batch sizes' different cuDNN and cuBLAS plans round differently and
    # the random decoder's near ties split most captions (printed only).
    check(first["f32_greedy_equal_one_card"] >= IMAGES - 2,
          phase + ": f32 sharded greedy tokens vs one card",
          first["f32_greedy_equal_one_card"])
    # Each rank's counts on each path, and the sum of all.
    for i, path in enumerate(("_greedy", "_beam")):
        expect_launches(results, phase + path, {
            name: [o["launches"][i][name] for o in outs] for name in KERNELS})
    expect_launches(results, phase, {
        name: sum(c[name] for o in outs for c in o["launches"])
        for name in KERNELS}, fused_beam=0)


# ---------------------------------------------------------------------------
# Slice 11: the reference's artifacts and the training data path's aids
# ---------------------------------------------------------------------------

SLICE11_ROOT = os.path.join(BUILD_DIR, "slice11")
COCO_TRAIN_IMAGES = 82783  # COCO-2014 train (reference: dataset.py:73-75)
CACHE_STEPS, CACHE_POOL = 40, 256  # 1,280 samples of 256 images, ~5 each


@contextlib.contextmanager
def slice11_root():
    """An ICD_TPU_ROOT under build/ with checkpoints/, models/ and the
    smoke's vocabulary (V = 10,000: <pad> first, then <start>, <end>,
    <unk> at START_ID, END_ID and the last id) in pkldata/; the
    environment variables the phases set are restored after."""
    import shutil

    from icd_tpu_torch.vocabulary import Vocabulary, save_vocab

    shutil.rmtree(SLICE11_ROOT, ignore_errors=True)
    for sub in ("checkpoints", "models", "pkldata"):
        os.makedirs(os.path.join(SLICE11_ROOT, sub))
    saved = {k: os.environ.get(k) for k in (
        "ICD_TPU_ROOT", "ICD_TPU_DEVICE_IMAGE_CACHE", "ICD_TPU_CKPT_ASYNC",
        "ICD_TPU_PROFILE")}
    os.environ["ICD_TPU_ROOT"] = SLICE11_ROOT
    vocab = Vocabulary()
    for word in (["<pad>"] + ["w{}".format(i) for i in range(1, START_ID)]
                 + ["<start>", "<end>", "<unk>"]):
        vocab.add_word(word)
    check(len(vocab) == VOCAB and vocab("<start>") == START_ID
          and vocab("<end>") == END_ID, "slice 11 vocabulary")
    save_vocab(vocab)
    try:
        yield SLICE11_ROOT
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def train_args(model, name, **kw):
    """The train CLI's arguments (icd_tpu_torch/train.py) at the smoke's
    widths."""
    from types import SimpleNamespace

    args = dict(model=model, model_name=name, embed_size=EMBED,
                decoder_dim=DEC_DIM, attention_dim=ATT_DIM,
                decoder_dropout=0.5, alpha_c=1.0, grad_clip=5.0,
                encoder_lr=1e-4, decoder_lr=1e-4, fine_tune_encoder=False,
                fine_tune_embedding=False, use_glove=False, use_bert=False,
                checkpoint=None, batch_size=TRAIN_BATCH, epochs=1,
                print_freq=100, amp=False, int8_encoder=False, workers=0,
                max_caption_length=-1)
    args.update(kw)
    return SimpleNamespace(**args)


def array_leaves(tree):
    """The arrays of a nested dict / list / tuple (optax's state tuples
    included), in order."""
    import numpy as np

    if isinstance(tree, dict):
        return [x for k in tree for x in array_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in array_leaves(v)]
    if isinstance(tree, (np.ndarray, np.generic, int, float)):
        return [np.asarray(tree)]
    return []


def trees_equal(a, b):
    """Same arrays, bit for bit, in the same order."""
    import numpy as np

    a, b = array_leaves(a), array_leaves(b)
    return len(a) == len(b) > 0 and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(a, b))


def phase_pth_artifacts(models, base, gen, results):
    """The reference's artifacts at full width: a torchvision-named
    ResNet-101 ``models/resnet101.pth`` and whole-module ``.pth.tar``
    checkpoints of both families, pickled by ``python -m
    icd_tpu_torch.export_reference`` from the reference skeleton
    (``testing.write_reference_skeleton``) out of the port's own
    ``.ckpt``; loaded back (``load_checkpoint``) to the same trees; the
    train entry's model building with resnet101.pth present and from
    ``--checkpoint x.pth.tar``, one f32 step each at batch 32, caption
    length 25; batch-64 bf16 captions of the loaded attention model
    through gen_captions' per-step beam (K1, its first call held
    against its plain version) and beam_eval's --fused captioner (K2,
    one launch a batch; K2 held against its plain version on the loaded
    model in f32) equal to the .ckpt's; and the loaded checkpoint
    exported again and reloaded to equal trees."""
    import torch

    from icd_tpu_torch import export_reference
    from icd_tpu_torch.beam_eval import caption_images
    from icd_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from icd_tpu_torch.decoding.serve import make_beam_captioner
    from icd_tpu_torch.export import (export_reference_checkpoint,
                                      resnet_to_torch_state_dict)
    from icd_tpu_torch.models.encoder import encoder_attention_forward
    from icd_tpu_torch.ops.fused_beam import beam_search_fused
    from icd_tpu_torch.params import (decoder_from_jax, decoder_to_jax,
                                      encoder_from_jax, encoder_to_jax,
                                      resnet_to_jax)
    from icd_tpu_torch.testing import write_reference_skeleton
    from icd_tpu_torch.training import attention
    from icd_tpu_torch.training.common import make_adam, resume_or_build
    from icd_tpu_torch.vocabulary import load_vocab

    with slice11_root() as root:
        ref = write_reference_skeleton(os.path.join(BUILD_DIR,
                                                    "reference_skeleton"))
        families = {"attention": models, "baseline": base}
        trees = {fam: (encoder_to_jax(m[0]), decoder_to_jax(m[1]))
                 for fam, m in families.items()}
        seconds = {}
        t0 = time.perf_counter()
        pth = os.path.join(root, "models", "resnet101.pth")
        torch.save(resnet_to_torch_state_dict(trees["attention"][0]["resnet"]),
                   pth)
        seconds["write_resnet101_pth"] = time.perf_counter() - t0
        loaded = {}
        for fam, (enc, dec) in trees.items():
            name = "pth_{}".format(fam)
            save_checkpoint(train_args(fam, name), 0, enc, dec, None, None,
                            {"epoch_losses": [[1.0]]})
            out = os.path.join(root, "checkpoints", name + "_0.pth.tar")
            t0 = time.perf_counter()
            export_reference.main([name + "_0.ckpt", out,
                                   "--reference_root", ref])
            seconds["export_" + fam] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = load_checkpoint(name=name + "_0.pth.tar")
            seconds["load_" + fam] = time.perf_counter() - t0
            check(got["config"]["model"] == fam and got["epoch"] == 0,
                  fam + " .pth.tar config", got["config"], got["epoch"])
            check(trees_equal(got["encoder"], enc)
                  and trees_equal(got["decoder"], dec),
                  fam + " .pth.tar trees equal to the .ckpt's")
            again = os.path.join(root, "checkpoints", name + "_again.pth.tar")
            t0 = time.perf_counter()
            export_reference_checkpoint(got, again, reference_root=ref)
            seconds["export_again_" + fam] = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = load_checkpoint(name=name + "_again.pth.tar",
                                   verbose=False)
            seconds["reload_" + fam] = time.perf_counter() - t0
            check(trees_equal(back["encoder"], got["encoder"])
                  and trees_equal(back["decoder"], got["decoder"]),
                  fam + " export -> reload trees equal")
            loaded[fam] = got
        sizes = {os.path.basename(p): os.path.getsize(p) for p in [pth] + [
            os.path.join(root, "checkpoints", "pth_{}_0.pth.tar".format(f))
            for f in trees]}

        # The train entry's model building (train -> resume_or_build):
        # from scratch with resnet101.pth present, and --checkpoint
        # x.pth.tar; one f32 step each.
        vocab = load_vocab()
        batch = train_batches(gen, 1, seed=700)[0]
        steps = {}
        for label, kw in (("resnet101_pth", {}),
                          ("checkpoint_pth_tar", dict(
                              checkpoint="pth_attention_0.pth.tar"))):
            args = train_args("attention", "pth_train", **kw)
            first, enc, dec, opt_state, _ = resume_or_build(
                args, attention.build_attention, vocab, "cuda")
            check(trees_equal(resnet_to_jax(enc.resnet),
                              trees["attention"][0]["resnet"]),
                  label + ": the trunk is the file's")
            optimizer = make_adam(args, enc, dec, opt_state)
            step = attention.make_train_step(enc, dec, optimizer, 1.0, 0.0,
                                             5.0)
            loss = attention.batch_step(step, "cuda")(batch).item()
            check(math.isfinite(loss), label + " step loss", loss)
            steps[label] = dict(first_epoch=first, loss=loss)

        # Captions of the loaded model against the .ckpt's, batch 64 bf16.
        imgs = uint8_images(IMAGES, seed=11).cuda()
        ckpt_models = [encoder_from_jax(trees["attention"][0]),
                       decoder_from_jax(trees["attention"][1])]
        pth_models = [encoder_from_jax(loaded["attention"]["encoder"]),
                      decoder_from_jax(loaded["attention"]["decoder"])]
        tokens = {}
        for label, (enc, dec) in (("ckpt", ckpt_models), ("pth", pth_models)):
            captioner = make_beam_captioner(enc, dec, START_ID, END_ID,
                                            beam_size=BEAMS,
                                            compute_dtype=torch.bfloat16,
                                            device="cuda")
            reset_launches()
            with k1_first_call() as seen:
                out = captioner(imgs)
            torch.cuda.synchronize()
            # The .pth run's counts stay recorded: it runs second.
            k1_pth = expect_launches(
                results, "pth_artifacts/gen_captions",
                fused_attention=out["steps"], fused_beam=0)["fused_attention"]
            tokens[label] = out["seq"].cpu()
            if label == "pth":
                k1_errs = k1_call_errors(seen)
        check(torch.equal(tokens["ckpt"], tokens["pth"]),
              ".pth.tar beam tokens equal the .ckpt's")

        pool = uint8_images(130, seed=12).numpy()
        img_ids = list(range(1000, 1130))
        rows = {}
        for label, (enc, dec) in (("ckpt", ckpt_models), ("pth", pth_models)):
            captioner = make_beam_captioner(
                enc, dec, START_ID, END_ID, beam_size=BEAMS,
                compute_dtype=torch.bfloat16, device="cuda",
                beam_fn=beam_search_fused)
            reset_launches()
            rows[label] = caption_images(
                captioner, img_ids, lambda ids: pool[[i - 1000 for i in ids]],
                vocab, IMAGES, log=lambda line: None)
            torch.cuda.synchronize()
            k2 = expect_launches(results, "pth_artifacts/beam_eval_fused",
                                 fused_attention=0, fused_beam=3)["fused_beam"]
        check(rows["ckpt"] == rows["pth"],
              ".pth.tar fused captions equal the .ckpt's")
        with torch.no_grad():
            grid = encoder_attention_forward(pth_models[0].cuda(),
                                             imgs[:8]).reshape(8, -1, ENC_DIM)
        _, k2_err, _ = k2_against_plain(pth_models[1].cuda(), grid, BEAMS,
                                        START_ID, END_ID, 50,
                                        "pth_artifacts")
        del pth_models, ckpt_models, enc, dec, optimizer, step
        torch.cuda.empty_cache()
    log("pth_artifacts", seconds=seconds, file_bytes=sizes,
        train_steps=steps, k1_launches=k1_pth, k2_launches_3_batches=k2,
        k1_first_call_err=dict(ctx=k1_errs[0], alpha=k1_errs[1]),
        k2_f32_alpha_err_vs_plain=k2_err,
        captions_equal=len(rows["pth"]), card=card_line())


class MemoryLoader:
    """A loader over in-memory batches, as ``training.common.train_epochs``
    reads one (``len``, iteration, ``dataset.img_size``)."""

    def __init__(self, batches, dataset=None):
        from types import SimpleNamespace

        self.batches = batches
        self.dataset = dataset or SimpleNamespace(img_size=224, img_ids=[])

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


def coco_like_batches(gen, seed):
    """CACHE_STEPS batches of train_f32's cell whose images repeat as
    COCO's ~5 captions an image make them (CACHE_POOL images, 5 samples
    each, shuffled), with ``img_ids``; each image made on the host from
    its id's seed."""
    import numpy as np

    from icd_tpu_torch.testing import seeded_captions

    rng = np.random.default_rng(seed)
    ids = rng.choice(COCO_TRAIN_IMAGES, CACHE_POOL, replace=False)
    order = rng.permutation(np.repeat(ids, CACHE_STEPS * TRAIN_BATCH
                                      // CACHE_POOL))
    pixels = {}

    def image(i):
        if i not in pixels:
            pixels[i] = np.random.default_rng(int(i)).integers(
                0, 256, (224, 224, 3), dtype=np.uint8)
        return pixels[i]

    batches = []
    for s in range(CACHE_STEPS):
        rows = [int(i) for i in order[s * TRAIN_BATCH:(s + 1) * TRAIN_BATCH]]
        batches.append(dict(
            imgs=np.stack([image(i) for i in rows]), img_ids=rows,
            captions=seeded_captions(gen, TRAIN_BATCH, TRAIN_LEN, VOCAB,
                                     START_ID, END_ID).numpy(),
            padded_lengths=np.full(TRAIN_BATCH, TRAIN_LEN, np.int32)))
    return batches


def timed_steps(run, batches):
    """``run`` over ``batches`` (an iterator; what the consumer does to
    get a batch is inside each step's events): (losses, per-step ms)."""
    import torch

    it = iter(batches)
    losses, events = [], []
    while True:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        batch = next(it, None)
        if batch is None:
            break
        losses.append(run(batch))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return (torch.stack(losses).tolist(),
            [s.elapsed_time(e) for s, e in events])


def phase_device_image_cache(models, gen, results):
    """``ICD_TPU_DEVICE_IMAGE_CACHE=12`` at COCO-2014 train's size (82,783
    distinct images of 224x224x3 uint8 on the card), train_f32's cell
    (batch 32, caption length 25, V = 10,000, dropout 0.5) for
    CACHE_STEPS steps whose ids repeat as COCO's captions do: losses
    equal to the bit to the direct path's on the same batches (both
    through ``stage_batches``), hits and misses, step ms with and
    without the cache, the buffer's bytes and the peak memory; then the
    same with a budget of 3 batches, where slots are evicted while the
    producer runs two batches ahead."""
    import copy
    from types import SimpleNamespace

    import torch

    from icd_tpu_torch.data.pipeline import device_image_cache_from_env
    from icd_tpu_torch.training.common import stage_batches

    batches = coco_like_batches(gen, seed=800)
    direct_batches = [{k: v for k, v in b.items() if k != "img_ids"}
                      for b in batches]
    runs = {}
    with slice11_root():
        reset_launches()
        run, _, _ = attention_trainer(models, 1e-4)
        losses, ms = timed_steps(run, stage_batches(
            MemoryLoader(direct_batches), "cuda"))
        runs["direct"] = dict(losses=losses, median_step_ms=median(ms))
        for label, gb in (("coco_12gb", "12"), ("three_batches", repr(
                3 * TRAIN_BATCH * 224 * 224 * 3 / (1 << 30)))):
            os.environ["ICD_TPU_DEVICE_IMAGE_CACHE"] = gb
            dataset = SimpleNamespace(img_size=224,
                                      img_ids=range(COCO_TRAIN_IMAGES))
            cache = device_image_cache_from_env(dataset, TRAIN_BATCH)
            check(cache is not None and dataset.return_ids, label + " cache")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            buf = cache.init_buffer("cuda")
            run, _, _ = attention_trainer(models, 1e-4)
            losses, ms = timed_steps(run, stage_batches(
                MemoryLoader(copy.deepcopy(batches)), "cuda",
                img_cache=cache, buf=buf))
            torch.cuda.synchronize()
            check(losses == runs["direct"]["losses"],
                  label + ": losses equal the direct path's to the bit",
                  losses[:3], runs["direct"]["losses"][:3])
            runs[label] = dict(
                budget_gb=float(gb), capacity_rows=cache.capacity,
                buffer_bytes=buf.numel() * buf.element_size(),
                hits=cache.hits, misses=cache.misses,
                median_step_ms=median(ms),
                peak_memory_bytes=torch.cuda.max_memory_allocated())
            del buf
            torch.cuda.empty_cache()
        expect_launches(results, "device_image_cache", fused_attention=0,
                        fused_beam=0)
    coco = runs["coco_12gb"]
    check(coco["capacity_rows"] == COCO_TRAIN_IMAGES
          and coco["misses"] == CACHE_POOL
          and coco["hits"] == CACHE_STEPS * TRAIN_BATCH - CACHE_POOL,
          "12 GB cache rows, hits and misses", coco)
    check(runs["three_batches"]["misses"] > CACHE_POOL,
          "the 3-batch budget evicts", runs["three_batches"])
    log("device_image_cache", steps=CACHE_STEPS, batch=TRAIN_BATCH,
        caption_length=TRAIN_LEN, distinct_images=CACHE_POOL,
        losses_first_last=[runs["direct"]["losses"][0],
                           runs["direct"]["losses"][-1]],
        direct_median_step_ms=runs["direct"]["median_step_ms"],
        coco_12gb=coco, three_batches=runs["three_batches"],
        card=card_line())


def phase_prefetch_async_ckpt(models, gen, results):
    """TRAIN_BATCHES steps of train_f32's cell fed three ways: each batch
    shipped by the step (sync), read on a thread and shipped by the step
    (host_thread, the loop before device_prefetch) and staged by
    ``device_prefetch`` (a side
    stream, a producer thread); in every run a checkpoint of the trained
    state after step 10 while training goes on, written synchronously or
    by the ``ICD_TPU_CKPT_ASYNC=1`` writer. Runs in turns (and again in
    reverse): the losses of every run equal to the bit, every file's
    trees and Adam state equal to the first sync save's; the median step
    ms before the save (the feeds), the save call's ms, the next step's
    and the median after (the writers)."""
    import torch

    from icd_tpu_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                          wait_pending_saves)
    from icd_tpu_torch.data.pipeline import host_prefetch
    from icd_tpu_torch.training.common import (checkpoint_snapshot,
                                               stage_batches)

    batches = train_batches(gen, TRAIN_BATCHES, seed=900)
    feeds = {
        "sync": lambda: iter([dict(b) for b in batches]),
        "host_thread": lambda: host_prefetch(iter([dict(b) for b in batches])),
        "prefetch": lambda: stage_batches(MemoryLoader(batches), "cuda")}
    plan = [("sync", False), ("prefetch", True), ("prefetch", False),
            ("host_thread", False)]
    runs, save_at = {}, 10
    with slice11_root():
        reset_launches()
        for i, (feed, async_save) in enumerate(plan + plan[::-1]):
            label = "{}/{}_save{}".format(feed, "async" if async_save
                                          else "sync", "" if i < 4 else "_2")
            run, enc, dec = attention_trainer(models, 1e-4)
            if async_save:
                os.environ["ICD_TPU_CKPT_ASYNC"] = "1"
            else:
                os.environ.pop("ICD_TPU_CKPT_ASYNC", None)
            losses, events, save_ms = [], [], None
            for step, batch in enumerate(feeds[feed](), 1):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in "se")
                start.record()
                losses.append(run(batch))
                end.record()
                events.append((start, end))
                if step == save_at:
                    t0 = time.perf_counter()
                    save_checkpoint(
                        train_args("attention", "ckpt{}".format(i)), save_at,
                        None, None, None, None, {},
                        snapshot=checkpoint_snapshot(enc, dec, run.optimizer))
                    save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            wait_pending_saves()
            torch.cuda.synchronize()
            ms = [s.elapsed_time(e) for s, e in events]
            wait_ms = (time.perf_counter() - t0) * 1e3
            saved = load_checkpoint(name="ckpt{}_{}.ckpt".format(i, save_at),
                                    verbose=False)
            losses = torch.stack(losses).tolist()
            if i == 0:
                first_losses, first_file = losses, saved
            check(losses == first_losses,
                  label + ": losses equal the synchronous path's to the bit")
            for key in ("encoder", "decoder", "decoder_optimizer"):
                check(trees_equal(saved[key], first_file[key]),
                      label + ": checkpoint " + key + " equals the sync save's")
            runs[label] = dict(
                median_step_ms_before_save=median(ms[:save_at]),
                save_call_ms=save_ms, step_after_save_ms=ms[save_at],
                median_step_ms_after_save=median(ms[save_at + 1:]),
                wait_at_end_ms=wait_ms)
        os.environ.pop("ICD_TPU_CKPT_ASYNC", None)
        expect_launches(results, "prefetch_async_ckpt", fused_attention=0,
                        fused_beam=0)
    log("prefetch_async_ckpt", steps=TRAIN_BATCHES, batch=TRAIN_BATCH,
        save_after_step=save_at, **runs, card=card_line())


def phase_profile_train(models, gen, results):
    """A short ``train_epochs`` run (4 steps and its checkpoint) under
    ``ICD_TPU_PROFILE``: the Chrome trace exists, holds CUDA kernel
    events and the ``train_step`` and ``checkpoint`` spans; its size and
    the top device kernels by time."""
    import shutil

    import torch

    from icd_tpu_torch.training import attention
    from icd_tpu_torch.training.common import make_adam, train_epochs

    batches = train_batches(gen, 4, seed=950)
    out_dir = os.path.join(BUILD_DIR, "profile_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    with slice11_root():
        os.environ["ICD_TPU_PROFILE"] = out_dir
        args = train_args("attention", "profiled")
        enc, dec = (copy.deepcopy(m) for m in models)
        optimizer = make_adam(args, enc, dec, None)
        step = attention.make_train_step(enc, dec, optimizer, 1.0, 0.5, 5.0)
        reset_launches()
        t0 = time.perf_counter()
        train_epochs(args, MemoryLoader(batches), attention.batch_step(
            step, "cuda", torch.Generator("cuda").manual_seed(1)), enc, dec,
            optimizer, 0, {}, device="cuda")
        seconds = time.perf_counter() - t0
        expect_launches(results, "profile_train", fused_attention=0,
                        fused_beam=0)
    path = os.path.join(out_dir, "train_profiled", "trace.json")
    check(os.path.exists(path), "profile trace written", path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e.get("dur", 0)
    spans = {name: sum(1 for e in events if e.get("name") == name
                       and e.get("cat") == "user_annotation")
             for name in ("train_step", "checkpoint")}
    check(kernels and spans["train_step"] == len(batches)
          and spans["checkpoint"] >= 1, "trace kernels and spans",
          len(kernels), spans)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    log("profile_train", steps=len(batches), seconds=seconds,
        trace_bytes=os.path.getsize(path), kernel_names=len(kernels),
        spans=spans, top=[dict(name=n[:60], ms=us / 1e3) for n, us in top],
        card=card_line())



def slice11(models, gen, results):
    """The phases of the reference's artifacts and the data path's aids."""
    phase_pth_artifacts(models, baseline_models(models), gen, results)
    phase_device_image_cache(models, gen, results)
    phase_prefetch_async_ckpt(models, gen, results)
    phase_profile_train(models, gen, results)


# ---------------------------------------------------------------------------
# The COCO detection eval and the notebook demo (coco_eval, captions_demo)
# ---------------------------------------------------------------------------

# val2017: 5,000 images of 640 x 480 (most), 80 categories, 36,781
# instances; COCO's maxDets is 100. Shares of instances by area:
# small (< 32^2) 41 %, medium 34 %, large (> 96^2) 25 %.
COCO_W, COCO_H, COCO_CATS = 640, 480, 80
COCO_GT_PER_IMAGE, COCO_CROWD = 36781 / 5000, 0.15
COCO_AREAS = ((0.41, 16, 32 ** 2), (0.34, 32 ** 2, 96 ** 2),
              (0.25, 96 ** 2, 300 ** 2))
COCO_BBOX_IMAGES, COCO_BBOX_DETS = 1000, 100
COCO_SEGM_IMAGES, COCO_SEGM_DETS = 500, 20


def coco_box(rng):
    """A box whose area falls in COCO's small / medium / large shares."""
    share = rng.random()
    for p, lo, hi in COCO_AREAS:
        if share < p:
            break
        share -= p
    area = rng.uniform(lo, hi)
    aspect = math.exp(rng.uniform(-0.7, 0.7))
    w = min(math.sqrt(area * aspect), COCO_W - 1.0)
    h = min(area / w, COCO_H - 1.0)
    x, y = rng.uniform(0, COCO_W - w), rng.uniform(0, COCO_H - h)
    return [float(x), float(y), float(w), float(h)]


def coco_polygon(rng, bb):
    """An octagon along the box's edges, each vertex moved inward by up
    to a tenth of the box."""
    import numpy as np

    x, y, w, h = bb
    fx = np.asarray([0, .5, 1, 1, 1, .5, 0, 0])
    fy = np.asarray([0, 0, 0, .5, 1, 1, 1, .5])
    jx, jy = rng.uniform(0, 0.1, 8), rng.uniform(0, 0.1, 8)
    px = x + w * (fx + np.where(fx < .5, jx, np.where(fx > .5, -jx, 0)))
    py = y + h * (fy + np.where(fy < .5, jy, np.where(fy > .5, -jy, 0)))
    return [float(v) for xy in zip(px, py) for v in xy]


def uncompressed_rle(m):
    """A dense (h, w) mask as an uncompressed RLE dict, the form of COCO's
    crowd annotations."""
    import numpy as np

    flat = m.reshape(-1, order="F")
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
    return {"size": list(m.shape),
            "counts": ([0] if flat[0] else []) + runs.tolist()}


def coco_instances(seed, n_images, dets_per_image, segm, perfect=False):
    """(ground-truth dataset, results) at val2017's density: Poisson(7.36)
    objects an image, a category of 80, 15 % crowd (bbox: the box; segm:
    an octagon polygon, crowd ones an uncompressed RLE); results (what a
    detector writes: image_id, category_id, score, and a bbox, or an RLE
    from frPyObjects) of which one an object is that object moved by up
    to 5 % of its size (its category kept 9 times in 10, its score drawn
    from [0.3, 1)) and the rest random boxes (scores from [0, 0.7)).
    ``perfect``: no crowd, and one result an object, the object itself
    (score 1)."""
    import numpy as np

    from icd_tpu_torch.native import mask as maskUtils

    rng = np.random.default_rng(seed)
    images = [{"id": i + 1, "width": COCO_W, "height": COCO_H,
               "file_name": "{:012d}.jpg".format(i + 1)}
              for i in range(n_images)]
    cats = [{"id": c + 1, "name": "cat{}".format(c),
             "supercategory": "super{}".format(c // 10)}
            for c in range(COCO_CATS)]
    gts, results = [], []
    for img in images:
        objects = []
        for _ in range(rng.poisson(COCO_GT_PER_IMAGE)):
            bb = coco_box(rng)
            ann = {"id": len(gts) + 1, "image_id": img["id"],
                   "category_id": int(rng.integers(1, COCO_CATS + 1)),
                   "bbox": bb, "area": bb[2] * bb[3],
                   "iscrowd": int(not perfect and rng.random() < COCO_CROWD)}
            if segm:
                poly = coco_polygon(rng, bb)
                rle = maskUtils.frPyObjects([poly], COCO_H, COCO_W)[0]
                ann["area"] = float(maskUtils.area(rle))
                ann["segmentation"] = (
                    uncompressed_rle(maskUtils.decode(rle)) if ann["iscrowd"]
                    else [poly])
            gts.append(ann)
            objects.append(ann)
        n_dets = len(objects) if perfect else dets_per_image
        for d in range(n_dets):
            if d < len(objects):
                src = objects[d]
                bb = list(src["bbox"])
                cat = src["category_id"]
                if not perfect:
                    bb = [v + float(rng.uniform(-0.05, 0.05)) * s
                          for v, s in zip(bb, bb[2:] * 2)]
                    if rng.random() < 0.1:
                        cat = int(rng.integers(1, COCO_CATS + 1))
            else:
                bb, cat = coco_box(rng), int(rng.integers(1, COCO_CATS + 1))
            # a detector scores its hits above its misses, mostly
            score = (1.0 if perfect else float(rng.uniform(0.3, 1.0))
                     if d < len(objects) else float(rng.uniform(0.0, 0.7)))
            res = {"image_id": img["id"], "category_id": cat,
                   "score": score}
            if segm:
                poly = (src["segmentation"][0] if perfect
                        else coco_polygon(rng, bb))
                res["segmentation"] = maskUtils.frPyObjects(
                    [poly], COCO_H, COCO_W)[0]
            else:
                res["bbox"] = bb
            results.append(res)
    return ({"images": images, "annotations": gts, "categories": cats},
            results)


def coco_eval_run(dataset, results, iou_type):
    """``loadRes`` and COCOeval's evaluate / accumulate / summarize over
    one ground truth, with the host seconds of each; their printing goes
    to a buffer. Returns (stats, seconds)."""
    import io

    from icd_tpu_torch.data.coco import COCO
    from icd_tpu_torch.data.cocoeval import COCOeval

    seconds = {}
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        gt = COCO()
        gt.dataset = dataset
        gt.createIndex()
        dt = gt.loadRes(results)
        seconds["index_and_loadRes_s"] = time.perf_counter() - t0
        ev = COCOeval(gt, dt, iouType=iou_type)
        for step in ("evaluate", "accumulate", "summarize"):
            t0 = time.perf_counter()
            getattr(ev, step)()
            seconds[step + "_s"] = time.perf_counter() - t0
    return [float(v) for v in ev.stats], seconds


def mask_library_checks(seed=31, n=64):
    """On n seeded COCO-sized masks (half unions of boxes, half noise):
    decode(encode(m)) == m, area == m.sum(), and iou (the first half as
    detections, the second as ground truth, crowd flags alternating)
    equal to the IoU of the dense masks computed with numpy."""
    import numpy as np

    from icd_tpu_torch.native import mask as maskUtils

    rng = np.random.default_rng(seed)
    masks = np.zeros((COCO_H, COCO_W, n), np.uint8, order="F")
    for i in range(n):
        if i % 2:
            masks[:, :, i] = rng.random((COCO_H, COCO_W)) < 0.3
        else:
            for _ in range(3):
                x, y, w, h = (int(v) for v in coco_box(rng))
                masks[y:y + h + 1, x:x + w + 1, i] = 1
    rles = maskUtils.encode(masks)
    check(np.array_equal(maskUtils.decode(rles), masks),
          "mask decode(encode(m)) == m")
    check(np.array_equal(maskUtils.area(rles),
                         masks.reshape(-1, n).sum(0)), "mask area == m.sum()")
    half = n // 2
    flat = masks.reshape(-1, n, order="F").astype(np.float64)
    dt, gt = flat[:, :half], flat[:, half:]
    inter = dt.T @ gt  # exact: integers below 2^53
    dt_area, gt_area = dt.sum(0)[:, None], gt.sum(0)[None, :]
    crowd = np.arange(half) % 2
    union = np.where(crowd[None, :] == 1, dt_area,
                     dt_area + gt_area - inter)
    want = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    got = maskUtils.iou(rles[:half], rles[half:], crowd.tolist())
    check(np.array_equal(got, want), "mask iou == dense numpy IoU",
          float(np.abs(got - want).max()))
    return {"masks": n, "size": [COCO_H, COCO_W],
            "runs": int(sum(len(r["counts"]) for r in rles))}


def phase_coco_eval():
    """The port's COCO detection eval on the host of the card's machine
    (no kernel of the card is involved): the mask library's build, its
    checks on 64 masks, a perfect-detection set of each iouType (AP must
    be 1.0) and the timed eval at val2017's density: bbox over
    COCO_BBOX_IMAGES images x 100 results, segm over COCO_SEGM_IMAGES x
    20."""
    from icd_tpu_torch.native import mask as maskUtils

    t0 = time.perf_counter()
    maskUtils.LIBRARY.load()
    build_s = time.perf_counter() - t0
    masks = mask_library_checks()
    perfect = {}
    for iou_type in ("bbox", "segm"):
        stats, _ = coco_eval_run(*coco_instances(
            41, 50, 0, iou_type == "segm", perfect=True), iou_type)
        perfect[iou_type] = stats[0]
        check(stats[0] == 1.0, "perfect {} detections AP".format(iou_type),
              stats)
    runs = {}
    for iou_type, n_images, dets in (
            ("bbox", COCO_BBOX_IMAGES, COCO_BBOX_DETS),
            ("segm", COCO_SEGM_IMAGES, COCO_SEGM_DETS)):
        t0 = time.perf_counter()
        dataset, results = coco_instances(43, n_images, dets,
                                          iou_type == "segm")
        made_s = time.perf_counter() - t0
        stats, seconds = coco_eval_run(dataset, results, iou_type)
        check(len(stats) == 12 and all(
            math.isfinite(v) and -1 <= v <= 1 for v in stats)
            and stats[0] > 0, iou_type + " stats", stats)
        runs[iou_type] = dict(images=n_images, results_per_image=dets,
                              ground_truth=len(dataset["annotations"]),
                              data_s=made_s, stats=stats, **seconds)
    log("coco_eval", library=maskUtils.LIBRARY.path(), build_s=build_s,
        mask_checks=masks, perfect_ap=perfect, clock="host", **runs,
        card=card_line())


def phase_captions_demo(models, base, bert_state, results):
    """``captions_demo.caption_teacher_forced`` (the notebook's argmax
    captions under teacher forcing) on the card for the full-width
    attention, baseline and --use_bert models over 3 seeded uint8 images
    and Zipf captions (their own seeded generator), f32 with TF32 off,
    against the same on the CPU. Each caption's loss from its scores,
    within eval_f32's limit (1e-5 relative): the card's decoder on the
    CPU's encoder output (and BERT embeddings), and the whole forward,
    which the card's run with TF32 on must exceed. The words that agree
    and the captions are printed."""
    import numpy as np
    import torch

    from icd_tpu_torch.captions_demo import (caption_teacher_forced,
                                             decoder_scores, image_features)
    from icd_tpu_torch.models.bert_embed import BertCaptionEmbedder
    from icd_tpu_torch.testing import f32_products, seeded_captions

    bert, tokenizer, vocab = bert_state
    imgs = uint8_images(3, seed=47).numpy()
    captions = [row[row != 0] for row in seeded_captions(
        torch.Generator().manual_seed(7), 3, 16, VOCAB, START_ID, END_ID,
        min_words=5).numpy()]
    families = {"attention": models, "baseline": base,
                "bert": bert_models(models)}

    def mtype(family):
        return "baseline" if family == "baseline" else "attention"

    def losses(scores, family):
        # Every position but <end>'s: the baseline decoder pins <end>'s
        # score at -1e9, so a loss over it would be ~1e9 and hide every
        # difference below its rounding; the attention decoders' <end>
        # comes from one steered LSTM unit of large weights (steer_end),
        # which magnifies the trunk's f32 difference at that position
        # (on the H100: 1.3e-5 to 1.9e-5 with it, 1.7e-6 without).
        offset = 0 if family == "baseline" else 1
        out = []
        for s, cap in zip(scores, captions):
            target = torch.as_tensor(cap[offset:], dtype=torch.long)
            keep = target != END_ID
            out.append(torch.nn.functional.cross_entropy(
                s[0].cpu()[keep], target[keep]))
        return torch.stack(out)

    def rel(got, want):
        return ((got - want).abs() / want.abs()).max().item()

    def run(device):
        out = {}
        for family, (enc, dec) in families.items():
            if device == "cpu":
                enc, dec = copy.deepcopy(enc).cpu(), copy.deepcopy(dec).cpu()
            embedder = None
            if family == "bert":
                embedder = BertCaptionEmbedder(
                    vocab, model=copy.deepcopy(bert), tokenizer=tokenizer,
                    device=device)
            t0 = time.perf_counter()
            words = [caption_teacher_forced(mtype(family), enc, dec, img,
                                            cap, vocab, bert_embedder=embedder)
                     for img, cap in zip(imgs, captions)]
            seconds = time.perf_counter() - t0
            feats = [image_features(mtype(family), enc, img) for img in imgs]
            scores = [decoder_scores(mtype(family), dec, f, cap,
                                     embedder).cpu()
                      for f, cap in zip(feats, captions)]
            out[family] = dict(enc=enc, dec=dec, embedder=embedder,
                               words=words, seconds=seconds, scores=scores,
                               feats=[f.cpu() for f in feats])
        return out

    f32_products()
    reset_launches()
    card = run("cuda")
    # Two float forwards an image (the caption's, then the features'),
    # three images, three families.
    expect_launches(results, "captions_demo", fused_attention=0, fused_beam=0,
                    bn_epilogue=100 * 2 * 3 * 3)
    cpu = run("cpu")
    out = {}
    for family in families:
        c, p = card[family], cpu[family]
        want = losses(p["scores"], family)
        # the card's decoder on the CPU's encoder output and embeddings
        cpu_embedder = p["embedder"]
        same = [decoder_scores(
            mtype(family), c["dec"], f, cap,
            None if cpu_embedder is None else
            (lambda caps: cpu_embedder(caps).to("cuda")))
            for f, cap in zip(p["feats"], captions)]
        f32_products(tf32=True)
        tf32 = [decoder_scores(mtype(family), c["dec"], image_features(
            mtype(family), c["enc"], img), cap, c["embedder"])
            for img, cap in zip(imgs, captions)]
        f32_products()
        for s, cap in zip(c["scores"], captions):
            offset = 0 if family == "baseline" else 1
            check(s.shape == (1, len(cap) - offset, VOCAB)
                  and bool(s.isfinite().all()), family + " demo scores",
                  s.shape)
        equal = sum(a == b for w, cw in zip(c["words"], p["words"])
                    for a, b in zip(w.split(), cw.split()))
        total = sum(max(len(w.split()), len(cw.split()))
                    for w, cw in zip(c["words"], p["words"]))
        # <end>'s column, pinned at -1e9 on the baseline decoder, left out
        keep = torch.arange(VOCAB) != END_ID
        out[family] = dict(
            words_equal=equal, words=total,
            loss_rel_err_vs_cpu=rel(losses(c["scores"], family), want),
            decoder_loss_rel_err_same_input=rel(losses(same, family), want),
            tf32_loss_rel_err_vs_cpu=rel(losses(tf32, family), want),
            scores_rel_err_vs_cpu=max(rel_err(s[..., keep], q[..., keep])
                                      for s, q in zip(c["scores"],
                                                      p["scores"])),
            features_rel_err_vs_cpu=max(rel_err(f, q) for f, q in zip(
                c["feats"], p["feats"])),
            card_seconds=c["seconds"], cpu_seconds=p["seconds"],
            card_captions=c["words"], cpu_captions=p["words"])
    log("captions_demo", images=len(imgs), k1_launches=0, k2_launches=0,
        **out)
    for family, row in out.items():
        # As eval_f32: the whole forward inherits the f32 trunk's
        # card-vs-CPU difference (on the H100 the grid's 5.9e-4 of its
        # largest value at batch 1, inside path_f32's 1e-3), ~2e-6 on a
        # loss; TF32 moves them by 4.7e-5 (baseline) to 1.6e-3.
        check(row["decoder_loss_rel_err_same_input"] <= 1e-5,
              family + " demo decoder losses card vs CPU",
              row["decoder_loss_rel_err_same_input"])
        check(row["loss_rel_err_vs_cpu"] <= 1e-5
              < row["tf32_loss_rel_err_vs_cpu"],
              family + " demo losses card vs CPU, TF32",
              row["loss_rel_err_vs_cpu"], row["tf32_loss_rel_err_vs_cpu"])


def slice12(models, bert_state, results):
    """The phases of the COCO detection eval and the notebook demo."""
    phase_coco_eval()
    phase_captions_demo(models, baseline_models(models), bert_state,
                        results)


SLICE13_ROOT = os.path.join(BUILD_DIR, "slice13")
S13_TRAIN, S13_VAL = 200, 130  # the corpus of the file-fed phases
S13_NAME = "s13"


def phase_jpeg_codec():
    """The port's JPEG codec on this machine's host: the library built by
    g++ (seconds; "cached" when build/ held it), testing.codec_corpus()
    (24 JPEGs of the port's encoder: each subsampling, progressive,
    restart markers, grey, odd sizes, 640x480) decoded to
    CODEC_CORPUS_DIGEST, the digest of PIL's decode of the same files
    (tests/test_torch_jpeg.py), so this machine's build gives PIL's
    pixels without PIL; decode, decode + resize to 224x224 and encode ms
    of one 640x480 4:2:0 quality-90 image on one thread."""
    from icd_tpu_torch import testing
    from icd_tpu_torch.native import jpeg

    path = jpeg.library_path()
    cached = os.path.exists(path)
    t0 = time.perf_counter()
    jpeg.load()
    build_s = time.perf_counter() - t0
    corpus = testing.codec_corpus()
    t0 = time.perf_counter()
    decoded = [jpeg.decode(data) for _, data in corpus]
    corpus_decode_s = time.perf_counter() - t0
    digest = testing.pixel_digest(decoded)
    check(digest == testing.CODEC_CORPUS_DIGEST,
          "codec corpus decoded to PIL's digest", digest)
    data = dict(corpus)["420_q90"]
    img = jpeg.decode(data)
    check(img.shape == (480, 640, 3), "640x480 corpus file", img.shape)

    def host_ms(fn):  # the median of 30 calls after one warm-up call
        return median(trial_seconds(lambda i: fn(), 30, "cpu", 1)) * 1e3

    log("jpeg_codec", library=os.path.basename(path), library_cached=cached,
        build_s=build_s, files=len(corpus),
        bytes=sum(len(d) for _, d in corpus), digest=digest,
        digest_equals_pil=True, corpus_decode_s=corpus_decode_s,
        threads=1, decode_ms_640x480=host_ms(lambda: jpeg.decode(data)),
        decode_resize_ms_640x480=host_ms(
            lambda: jpeg.decode_resize(data, 224, 224)),
        encode_ms_640x480=host_ms(lambda: jpeg.encode(img, quality=90)))


@contextlib.contextmanager
def slice13_root():
    """build/slice13 as ICD_TPU_ROOT (made anew); the environment
    variables the phases set are restored after."""
    import shutil

    shutil.rmtree(SLICE13_ROOT, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in (
        "ICD_TPU_ROOT", "ICD_TPU_LOSS_FETCH_BLOCK", "ICD_TPU_NATIVE_LOADER")}
    os.environ["ICD_TPU_ROOT"] = SLICE13_ROOT
    os.environ.pop("ICD_TPU_NATIVE_LOADER", None)
    try:
        yield SLICE13_ROOT
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().strip().splitlines()


def phase_jpeg_corpus(root):
    """``python -m icd_tpu_torch.make_synthetic_coco`` into build/slice13
    at 640x480 with realistic captions, 5 an image (S13_TRAIN train and
    S13_VAL val images), then ``python -m icd_tpu_torch.init --vocab
    True --vocab_threshold 1``: no PIL on this machine. Then
    ``ops.image.resize_bilinear`` (JAX's antialiased bilinear resize) of
    8 of the val images, decoded, from 640x480 to 224x224 on the card
    against the CPU: within 2e-3 on the 0-255 scale, the limit the CPU
    tests hold it to against JAX (f32 sums over the antialias taps in
    another order). Returns the vocabulary."""
    import numpy as np
    import torch

    from icd_tpu_torch import init, make_synthetic_coco
    from icd_tpu_torch.native import jpeg
    from icd_tpu_torch.ops.image import resize_bilinear
    from icd_tpu_torch.vocabulary import load_vocab

    t0 = time.perf_counter()
    quiet(make_synthetic_coco.main, [
        root, "--train", str(S13_TRAIN), "--val", str(S13_VAL),
        "--img_size", "640x480", "--realistic", "--captions_per_image",
        "5"])
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quiet(init.main, ["--vocab", "True", "--vocab_threshold", "1"])
    vocab_s = time.perf_counter() - t0
    vocab = load_vocab()
    nbytes, counts = 0, {}
    for split in ("train", "val"):
        img_dir = os.path.join(root, "cocoapi", "images", split + "2014")
        names = sorted(os.listdir(img_dir))
        counts[split] = len(names)
        for name in names:
            nbytes += os.path.getsize(os.path.join(img_dir, name))
        with open(os.path.join(img_dir, names[0]), "rb") as f:
            check(jpeg.size(f.read()) == (640, 480), split + " image size")
    check(counts == {"train": S13_TRAIN, "val": S13_VAL}, "corpus files",
          counts)
    val_dir = os.path.join(root, "cocoapi", "images", "val2014")
    frames = []
    for name in sorted(os.listdir(val_dir))[:8]:
        with open(os.path.join(val_dir, name), "rb") as f:
            frames.append(jpeg.decode(f.read()))
    frames = torch.from_numpy(np.stack(frames))
    resized = resize_bilinear(frames.cuda(), (224, 224))
    torch.cuda.synchronize()
    resize_err = (resized.cpu() - resize_bilinear(frames, (224, 224))).abs(
        ).max().item()
    check(tuple(resized.shape) == (8, 224, 224, 3) and resize_err <= 2e-3,
          "resize_bilinear card vs CPU", tuple(resized.shape), resize_err)
    log("jpeg_corpus", train_images=S13_TRAIN, val_images=S13_VAL,
        captions_per_image=5, img_size="640x480", bytes=nbytes,
        seconds=corpus_s, images_per_s=(S13_TRAIN + S13_VAL) / corpus_s,
        vocab=len(vocab), vocab_seconds=vocab_s,
        resize_bilinear_640x480_to_224_max_err_card_vs_cpu=resize_err)
    return vocab


def slice13_checkpoint(root, models, vocab):
    """checkpoints/s13_0.ckpt: the full-width attention model over the
    corpus's vocabulary: ``full_width_models``' ResNet-101 with its BN
    statistics re-estimated on 16 of the corpus's train images (on the
    noise images' statistics the shapes' grids are far from the scale
    the steered <end> unit reads, and every caption ends at once), and a
    decoder from a generator seeded 13 (A = H = E = 512), steered to
    finish captions. Returns (encoder, decoder)."""
    import numpy as np
    import torch

    from icd_tpu_torch.data.dataset import decode_image

    from icd_tpu_torch.checkpoint import save_checkpoint
    from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                                init_attention_decoder)
    from icd_tpu_torch.params import decoder_to_jax, encoder_to_jax
    from icd_tpu_torch.testing import steer_end

    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim = ATT_DIM, DEC_DIM
    params.embed_size, params.vocab = EMBED, range(len(vocab))
    decoder = init_attention_decoder(torch.Generator().manual_seed(13),
                                     params, device="cuda")
    steer_end(decoder, vocab("<end>"))
    encoder = copy.deepcopy(models[0])
    img_dir = os.path.join(root, "cocoapi", "images", "train2014")
    calibrate_bn(encoder, torch.as_tensor(np.stack([
        decode_image(os.path.join(img_dir, name))
        for name in sorted(os.listdir(img_dir))[:16]])))
    save_checkpoint(train_args("attention", S13_NAME), 0,
                    encoder_to_jax(encoder), decoder_to_jax(decoder),
                    None, None, {"epoch_losses": [[1.0]]})
    return encoder, decoder


def val_files(root):
    img_dir = os.path.join(root, "cocoapi", "images", "val2014")
    return [os.path.join(img_dir, n) for n in sorted(os.listdir(img_dir))]


def phase_gen_captions_file(root, results):
    """``python -m icd_tpu_torch.gen_captions s13_0.ckpt <val JPEG>
    --encoder float --dtype f32`` (TF32 off, the per-step beam, k = 5) on
    the card and on the CPU: K1 launched once a step, its first call
    held against its plain version (f32: ctx atol 2e-5, alpha atol
    2e-6), and the card's output lines, the caption's words included,
    equal to the CPU's."""
    import torch

    from icd_tpu_torch import gen_captions
    from icd_tpu_torch.ops.fused_attention import fused_attention_reference

    image = val_files(root)[0]
    argv = [S13_NAME + "_0.ckpt", image, "--encoder", "float", "--dtype",
            "f32"]
    reset_launches()
    t0 = time.perf_counter()
    with k1_first_call() as seen:
        _, card = quiet(gen_captions.main, argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    # One image, one forward of the float trunk.
    counts = expect_launches(results, "gen_captions_file", fused_beam=0,
                             bn_epilogue=100, int8_epilogue=0)
    k1, k2 = counts["fused_attention"], counts["fused_beam"]
    check(k1 >= 1, "gen_captions_file: K1 launches", k1, k2)
    args, kw, (ctx, alpha) = seen[0]
    ref_ctx, ref_alpha = fused_attention_reference(*args, **kw)
    ctx_err = (ctx - ref_ctx).abs().max().item()
    alpha_err = (alpha - ref_alpha).abs().max().item()
    check(ctx.dtype == torch.float32 and ctx_err <= 2e-5
          and alpha_err <= 2e-6, "gen_captions_file: K1 vs plain, f32",
          ctx_err, alpha_err)
    t0 = time.perf_counter()
    _, cpu = quiet(gen_captions.main, argv + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    check(card == cpu and len(card[-1].split()) >= 3,
          "gen_captions_file: card words equal the CPU's", card, cpu)
    log("gen_captions_file", image=os.path.basename(image), k1_launches=k1,
        k2_launches=k2, k1_ctx_err_vs_plain=ctx_err,
        k1_alpha_err_vs_plain=alpha_err, card_s=card_s, cpu_s=cpu_s,
        words_equal_cpu=True, caption=card[-1])


def phase_beam_eval_files(root, model, results):
    """``python -m icd_tpu_torch.beam_eval s13_0.ckpt --fused`` and the
    per-step ``beam_eval`` (the CLI's defaults otherwise: the int8
    trunk calibrated on the first val batch, bf16, batch 64) over the
    S13_VAL val files, read by the port's codec: 130 results each, K2
    three launches on --fused (K1 none), K1 at least three on the
    per-step run (K2 none; its first call held against the plain
    version with phase_k1's bf16 limits); then K2 against its plain
    version and the per-step search at this vocabulary in f32, on the
    f32 grid of the first 8 val files."""
    import numpy as np
    import torch

    from icd_tpu_torch import beam_eval
    from icd_tpu_torch.data.dataset import decode_image
    from icd_tpu_torch.models.encoder import encoder_attention_forward
    from icd_tpu_torch.testing import f32_products
    from icd_tpu_torch.vocabulary import load_vocab

    act_maxes = os.path.join(root, "act_maxes.npy")
    rows = {}
    for label, extra in (("fused", ["--fused"]), ("per_step", [])):
        out = os.path.join(root, "eval_data", "s13_{}.json".format(label))
        argv = [S13_NAME + "_0.ckpt", "--act_maxes", act_maxes, "--out",
                out, "--device", "cuda"] + extra
        reset_launches()
        t0 = time.perf_counter()
        with k1_first_call() as seen:
            quiet(beam_eval.main, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fused = label == "fused"
        counts = expect_launches(results, "beam_eval_files/" + label,
                                 fused_attention=0 if fused else None,
                                 fused_beam=3 if fused else 0)
        k1, k2 = counts["fused_attention"], counts["fused_beam"]
        with open(out) as f:
            got = json.load(f)
        check(len(got) == S13_VAL and all(
            isinstance(r["caption"], str) for r in got),
            "beam_eval_files " + label + ": results", len(got))
        check(fused or k1 >= 3, "per-step beam_eval over files: K1 launches",
              k1, k2)
        k1_errs = None if fused else k1_call_errors(seen)
        rows[label] = dict(k1_launches=k1, k2_launches=k2, seconds=seconds,
                           captions_per_s=S13_VAL / seconds,
                           k1_errs_vs_plain=k1_errs, first=got[0])
    f32_products()
    imgs = torch.as_tensor(np.stack([decode_image(p) for p in
                                     val_files(root)[:8]])).to("cuda")
    with torch.inference_mode():
        grid = encoder_attention_forward(model[0], imgs,
                                         compute_dtype=torch.float32)
        vocab = load_vocab()
        _, err, loop_err = k2_against_plain(
            model[1], grid, BEAMS, vocab("<start>"), vocab("<end>"), 50,
            "beam_eval_files f32")
    log("beam_eval_files", images=S13_VAL, batch=IMAGES, vocab=len(vocab),
        k2_alpha_err_vs_plain_f32=err, k2_alpha_err_vs_loop_f32=loop_err,
        **rows)


def phase_train_files(root, results):
    """``python -m icd_tpu_torch.train`` (attention, f32, batch 32, one
    epoch over the S13_TRAIN x 5 captions, 8 loader workers) over the
    corpus's files, read by the port's codec through ``DataLoader`` and
    ``device_prefetch``; then the same run fed the same images as arrays
    decoded before it (``COCODataset._load_img`` served from memory):
    every step's loss equal to the bit. Each step's loss is fetched
    (ICD_TPU_LOSS_FETCH_BLOCK=1), so the train loop's Time column is the
    step: its median from files beside its median from arrays (the
    first step left out). Neither K1 nor K2 launches."""
    from icd_tpu_torch import train
    from icd_tpu_torch.checkpoint import load_checkpoint, unpack_checkpoint
    from icd_tpu_torch.data.dataset import COCODataset

    os.environ["ICD_TPU_LOSS_FETCH_BLOCK"] = "1"

    def run(name):
        argv = [name, "--model", "attention", "--batch_size",
                str(TRAIN_BATCH), "--epochs", "1", "--workers", "8",
                "--print_freq", "1", "--device", "cuda"]
        reset_launches()
        t0 = time.perf_counter()
        _, lines = quiet(train.main, argv)
        wall = time.perf_counter() - t0
        expect_launches(results, "train_files", fused_attention=0,
                        fused_beam=0)
        times = [float(t) * 1e3 for t in re.findall(r"Time: ([0-9.]+)",
                                                    "\n".join(lines))]
        losses = unpack_checkpoint(load_checkpoint(
            name=name + "_0.ckpt", verbose=False))[-1]["epoch_losses"][-1]
        return dict(losses=losses, step_ms=median(times[1:]),
                    steps=len(times), wall_s=wall)

    files = run("s13_files")
    dataset = COCODataset("train", vocab=object())
    t0 = time.perf_counter()
    arrays = {i: dataset._load_img(i) for i in dataset.img_ids}
    decode_s = time.perf_counter() - t0
    load = COCODataset._load_img
    COCODataset._load_img = lambda self, img_id: arrays[img_id]
    try:
        memory = run("s13_arrays")
    finally:
        COCODataset._load_img = load
    steps = math.ceil(S13_TRAIN * 5 / TRAIN_BATCH)
    check(len(files["losses"]) == len(memory["losses"]) == steps
          == files["steps"], "train_files steps", len(files["losses"]),
          steps)
    check(all(math.isfinite(v) for v in files["losses"]),
          "train_files losses finite")
    check(files["losses"] == memory["losses"],
          "train_files: losses from files equal to the bit those from "
          "arrays", files["losses"][:3], memory["losses"][:3])
    log("train_files", steps=steps, batch=TRAIN_BATCH, workers=8,
        losses_bit_equal=True, first_loss=files["losses"][0],
        last_loss=files["losses"][-1],
        step_ms_from_files=files["step_ms"],
        step_ms_from_arrays=memory["step_ms"],
        wall_s_from_files=files["wall_s"],
        wall_s_from_arrays=memory["wall_s"],
        decode_train_images_s=decode_s, train_images=len(arrays))


def phase_serving_e2e(models, results):
    """``bench_serving_e2e.run`` (the workload of ``python -m
    icd_tpu_torch.bench_serving_e2e``: 256 640x480 quality-90 JPEGs of
    the port's encoder, batch 64, the static-int8 baseline captioner
    with the W8A8 decoder, V = 10,000, 25 steps) with baseline_models'
    full-width models, 8 batches end to end: the host decode rate by
    thread count, h2d GB/s, end-to-end and device-only captions/s,
    min(host, device), the threads needed, the first batch's captions
    equal to the resident captioner's; no K1 or K2 launch."""
    from icd_tpu_torch import bench_serving_e2e

    base = baseline_models(models)
    t0 = time.perf_counter()
    blobs = bench_serving_e2e.make_jpegs(bench_serving_e2e.BATCH * 4, 0)
    make_s = time.perf_counter() - t0
    reset_launches()
    sweep, summary = bench_serving_e2e.run(base[0], base[1], blobs, "cuda",
                                           n_batches=8)
    expect_launches(results, "serving_e2e", fused_attention=0, fused_beam=0)
    check(summary["e2e_captions_equal_resident"],
          "serving_e2e: end-to-end captions equal the resident batch's")
    check(all(v > 0 for v in (summary["host_images_per_s"],
                              summary["e2e_captions_per_s"],
                              summary["device_captions_per_s"],
                              summary["h2d_GB_per_s"])),
          "serving_e2e rates", summary)
    log("serving_e2e", jpegs=len(blobs), make_jpegs_s=make_s,
        jpeg_bytes=sum(len(b) for b in blobs), sweep=sweep, **summary)


def slice13(models, results):
    """The phases of the port's JPEG codec and the file-fed paths."""
    phase_jpeg_codec()
    with slice13_root() as root:
        vocab = phase_jpeg_corpus(root)
        model = slice13_checkpoint(root, models, vocab)
        phase_gen_captions_file(root, results)
        phase_beam_eval_files(root, model, results)
        phase_train_files(root, results)
    phase_serving_e2e(models, results)


def nccl4():
    """``--nccl4``, on four cards: mesh_nccl1's one-rank reference, then
    mesh_gloo_shared's (2, 2) mesh over NCCL, one card a rank."""
    import torch

    check(torch.cuda.device_count() >= 4, "--nccl4 needs four cards",
          torch.cuda.device_count())
    results = {name: {"launches_by_path": {}} for name in KERNELS}
    phase_build()
    models = full_width_models()
    phase_mesh_nccl1(models, torch.Generator().manual_seed(7), results)
    phase_mesh_gloo_shared(results, backend="nccl")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    if sys.argv[1:] == ["--nccl4"]:
        nccl4()
        print(card_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    results = {name: {"launches_by_path": {}} for name in KERNELS}
    phase_build()
    phase_k1(results)
    phase_k3(results)
    phase_k4(results)
    phase_int8_conv()
    models = full_width_models()
    phase_k2(phase_path_f32(models, results), results)
    phase_profile(*phase_serve_bf16(models, results))
    fused = phase_serve_fused_bf16(models, results)
    phase_beam_eval(fused[0], results)
    phase_profile(*fused, phase="profile_fused",
                  table="profile_fused_beam.txt")
    act_maxes = phase_int8_encoder(models, results)
    phase_greedy(models, results)
    phase_serve_int8_greedy(models, act_maxes, results)
    phase_beam_eval(phase_serve_int8_beam(models, act_maxes, results),
                    results, phase="beam_eval_int8")
    base = baseline_models(models)
    phase_baseline_f32(base, results)
    phase_baseline_serve_bf16(base, act_maxes, results)
    phase_bench(base, results)
    phase_benches(models, base, results)
    gen = torch.Generator().manual_seed(7)
    phase_train_step_f32(models, gen, results)
    phase_eval_f32(phase_train_f32(models, gen, results), gen, results)
    base = train_baseline_models(models)
    phase_train_baseline_step_f32(base, gen, results)
    trained = phase_train_baseline(base, gen, results)
    phase_train_amp_step(models, base, gen, results)
    phase_train_int8_step(models, base, gen, results)
    phase_eval_baseline_f32(trained, gen, results)
    bert, tokenizer, vocab = phase_bert_f32(gen, results)
    phase_bert_int8(bert, tokenizer, vocab, gen, results)
    bmodels = bert_models(models)
    phase_train_bert_step_f32(bmodels, bert, tokenizer, vocab, gen, results)
    trained = phase_train_bert(bmodels, bert, tokenizer, vocab, gen, results)
    phase_eval_bert_f32(trained, bert, tokenizer, vocab, gen, results)
    phase_mesh_nccl1(models, gen, results)
    phase_mesh_gloo_shared(results)
    slice11(models, gen, results)
    slice12(models, (bert, tokenizer, vocab), results)
    slice13(models, results)
    log("total", seconds=time.perf_counter() - STARTED)

    k1 = dict(name="fused_attention", route="cuda",
              source="icd_tpu_torch/csrc/fused_attention.cu",
              replaces="icd_tpu/ops/fused_attention.py:45",
              library_ms=None, **results["fused_attention"])
    # No single PyTorch call computes a beam search: library_ms is null.
    k2 = dict(name="fused_beam", route="cuda",
              source="icd_tpu_torch/csrc/fused_beam.cu",
              replaces="icd_tpu/ops/fused_beam.py:99",
              library_ms=None, **results["fused_beam"])
    # No single PyTorch call computes BN, ReLU and the residual add.
    k3 = dict(name="bn_epilogue", route="cuda",
              source="icd_tpu_torch/csrc/bn_epilogue.cu", replaces=None,
              library_ms=None, **results["bn_epilogue"])
    # No single PyTorch call computes the int8 epilogue.
    k4 = dict(name="int8_epilogue", route="cuda",
              source="icd_tpu_torch/csrc/int8_epilogue.cu", replaces=None,
              library_ms=None, **results["int8_epilogue"])
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
