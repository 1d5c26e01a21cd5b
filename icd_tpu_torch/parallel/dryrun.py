"""Multi-rank dryrun on the CPU, the counterpart of ``__graft_entry__.py:46``
``dryrun_multichip``::

    python -m icd_tpu_torch.parallel.dryrun [N]      (N defaults to 8)

spawns N ranks in a gloo group on the CPU (``parallel.run_ranks``), lays
them out as a (N/2, 2) mesh (N even; (N, 1) otherwise) and runs the
JAX dryrun's nine phases at its shapes: a ResNet-101 trunk, 64x64
images, V = 128 x n_model, a baseline decoder with E = H = 64 and an
attention decoder with E = 32, A = H = 64, a global batch of N (each
data rank holding N / n_data rows), the decoders split over ``model``
on the vocabulary. Each phase checks its output and rank 0 prints one
line in the JAX dryrun's words:

 baseline          one f32 train step of the baseline model;
 baseline-amp      one --amp step (bf16 compute, f32 masters);
 attention         one attention step (dropout 0.5, alpha_c 1);
 attention-bert    one step on seeded BERT-shaped embeddings, table
                   frozen;
 baseline-int8enc  one --amp step over the static-int8 trunk, its tree
                   checked equal on every rank;
 serving           the baseline's sharded greedy captioner over an
                   (N, 1) mesh, 6 tokens;
 attention-eval    the teacher-forced eval step on the vocab-split
                   decoder, per-sample losses gathered;
 beam-serving      the sharded beam captioner, k = 3;
 ckpt-resume       rank 0 writes the checkpoint of the gathered shards,
                   every rank loads it, re-splits it and steps again.

Exits non-zero if any phase or rank fails.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch


class _Args:
    model_name = "dryrun"
    model = "attention"
    encoder_lr = 1e-4
    decoder_lr = 1e-4
    grad_clip = 5.0
    fine_tune_encoder = False
    fine_tune_embedding = True
    use_bert = False
    use_glove = False
    embed_size = 32
    decoder_dim = 64
    attention_dim = 64
    decoder_dropout = 0.5


def _rank(rank, world, root):
    from ..checkpoint import load_checkpoint, save_checkpoint, \
        unpack_checkpoint
    from ..decoding.serve import (make_sharded_beam_captioner,
                                  make_sharded_captioner)
    from ..models.attention import (AttentionDecoderParams,
                                    init_attention_decoder)
    from ..models.baseline import BaselineDecoderParams, init_baseline_decoder
    from ..models.encoder import init_encoder, init_encoder_attention
    from ..models.resnet_int8 import calibrate_act_maxes, quantize_resnet
    from ..params import (adam_state_to_jax, decoder_from_jax,
                          decoder_to_jax, encoder_from_jax, encoder_to_jax)
    from ..training import attention as ta
    from ..training import baseline as tb
    from ..training.common import _tree_tensors, make_adam
    from .mesh import (assert_replicated, gather_batch, make_mesh,
                       shard_batch)
    from .vocab import unshard_decoder

    t0 = time.perf_counter()

    def say(msg):
        if rank == 0:
            print("[{:6.1f}s] {}".format(time.perf_counter() - t0, msg),
                  flush=True)

    def finite(x, what):
        if not bool(torch.isfinite(torch.as_tensor(x)).all()):
            raise RuntimeError("{}: not finite: {}".format(what, x))
        return float(torch.as_tensor(x).float().mean())

    n_model = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world // n_model, n_model, device="cpu")
    say("mesh: {} over {} ranks, gloo".format(mesh, world))
    vocab = 128 * n_model
    batch = world
    gen = torch.Generator().manual_seed(0)

    p = BaselineDecoderParams()
    p.vocab_size, p.embed_size, p.hidden_size = vocab, 64, 64
    encoder = init_encoder(gen, 64, device="cpu")
    decoder = init_baseline_decoder(gen, p, device="cpu")
    args = _Args()
    optimizer = make_adam(args, encoder, decoder, None, mesh=mesh)
    imgs = np.zeros((batch, 64, 64, 3), np.uint8)
    captions = np.ones((batch, 12), np.int64)
    local = {key: torch.from_numpy(x) for key, x in shard_batch(
        {"imgs": imgs, "captions": captions}, mesh).items()}

    step = tb.make_train_step(encoder, decoder, optimizer, 0, 5.0,
                              mesh=mesh)
    loss = finite(step(local["imgs"], local["captions"], batch), "baseline")
    say("dryrun_multichip baseline ok: devices={} loss={}".format(world,
                                                                  loss))

    amp = tb.make_train_step(encoder, decoder, optimizer, 0, 5.0,
                             torch.bfloat16, mesh=mesh)
    loss = finite(amp(local["imgs"], local["captions"], batch), "amp")
    say("dryrun_multichip baseline-amp ok: devices={} loss={}".format(
        world, loss))

    ap = AttentionDecoderParams()
    ap.attention_dim, ap.decoder_dim, ap.embed_size = 64, 64, 32
    ap.vocab = range(vocab)
    att_encoder = init_encoder_attention(gen, device="cpu")
    att_decoder = init_attention_decoder(gen, ap, device="cpu")
    att_opt = make_adam(args, att_encoder, att_decoder, None, mesh=mesh)
    att_step = ta.make_train_step(att_encoder, att_decoder, att_opt, 1.0,
                                  0.5, 5.0, mesh=mesh)
    lengths = torch.from_numpy(shard_batch(np.full(batch, 11), mesh))
    dropout = torch.Generator().manual_seed(3)
    loss = finite(att_step(local["imgs"], local["captions"], lengths,
                           dropout, None, batch), "attention")
    say("dryrun_multichip attention ok: devices={} loss={}".format(world,
                                                                   loss))

    bert_args = _Args()
    bert_args.use_bert = True
    bert_opt = make_adam(bert_args, att_encoder, att_decoder, None,
                         mesh=mesh)
    bert_step = ta.make_train_step(att_encoder, att_decoder, bert_opt, 1.0,
                                   0.5, 5.0, mesh=mesh)
    embs = np.random.default_rng(5).normal(
        size=(batch, captions.shape[1] + 1, 32)).astype(np.float32)
    loss = finite(bert_step(local["imgs"], local["captions"], lengths,
                            dropout, torch.from_numpy(shard_batch(embs, mesh)),
                            batch), "attention-bert")
    say("dryrun_multichip attention-bert ok: devices={} loss={}".format(
        world, loss))

    qresnet = quantize_resnet(encoder.resnet, calibrate_act_maxes(
        encoder.resnet, torch.from_numpy(imgs), torch.float32))
    assert_replicated(_tree_tensors(qresnet), "the int8 trunk")
    i8_step = tb.make_train_step(encoder, decoder, optimizer, 0, 5.0,
                                 torch.bfloat16, qresnet, mesh=mesh)
    loss = finite(i8_step(local["imgs"], local["captions"], batch),
                  "baseline-int8enc")
    say("dryrun_multichip baseline-int8enc ok: devices={} loss={}".format(
        world, loss))

    serve_mesh = make_mesh(world, 1, device="cpu")
    unshard_decoder(decoder, mesh, optimizer)
    captioner = make_sharded_captioner(encoder, decoder, vocab - 3,
                                       vocab - 2, serve_mesh, max_len=6)
    toks = captioner(imgs)
    if tuple(toks.shape) != (batch, 6):
        raise RuntimeError("serving: tokens of shape {}".format(toks.shape))
    say("dryrun_multichip serving ok: devices={} toks_sharded=data".format(
        world))

    eval_step = ta.make_eval_step(att_encoder, att_decoder)
    per_sample, preds = (gather_batch(x, mesh) for x in eval_step(
        local["imgs"], local["captions"], lengths))
    if tuple(per_sample.shape) != (batch,) or tuple(preds.shape) != (
            batch, captions.shape[1] - 1):
        raise RuntimeError("attention-eval: shapes {} {}".format(
            per_sample.shape, preds.shape))
    loss = finite(per_sample, "attention-eval")
    say("dryrun_multichip attention-eval ok: devices={} loss={}".format(
        world, loss))

    unshard_decoder(att_decoder, mesh, att_opt)
    beam = make_sharded_beam_captioner(att_encoder, att_decoder, vocab - 3,
                                       vocab - 2, serve_mesh, beam_size=3)
    out = beam(imgs)
    if out["seq"].shape[0] != batch:
        raise RuntimeError("beam-serving: seq of shape {}".format(
            out["seq"].shape))
    say("dryrun_multichip beam-serving ok: devices={} k=3".format(world))

    os.environ["ICD_TPU_ROOT"] = root
    if rank == 0:
        save_checkpoint(args, 0, encoder_to_jax(att_encoder),
                        decoder_to_jax(att_decoder), None,
                        adam_state_to_jax(att_opt, att_decoder),
                        {"epoch_losses": [[1.0]]})
    torch.distributed.barrier()
    epoch, enc_tree, dec_tree, _, opt_state, metrics = unpack_checkpoint(
        load_checkpoint(name="dryrun_0.ckpt", verbose=False))
    if epoch != 0 or metrics["epoch_losses"] != [[1.0]]:
        raise RuntimeError("ckpt-resume: read back {} {}".format(epoch,
                                                                 metrics))
    r_encoder, r_decoder = encoder_from_jax(enc_tree), decoder_from_jax(
        dec_tree)
    r_opt = make_adam(args, r_encoder, r_decoder, opt_state, mesh=mesh)
    r_step = ta.make_train_step(r_encoder, r_decoder, r_opt, 1.0, 0.5, 5.0,
                                mesh=mesh)
    loss = finite(r_step(local["imgs"], local["captions"], lengths,
                         torch.Generator().manual_seed(9), None, batch),
                  "ckpt-resume")
    say("dryrun_multichip ckpt-resume ok: devices={} loss={}".format(
        world, loss))
    return True


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    print("dryrun: {} ranks, gloo on the CPU".format(n), flush=True)
    with tempfile.TemporaryDirectory(prefix="icd_dryrun_ckpt_") as root:
        from .mesh import run_ranks

        run_ranks(_rank, n, args=(root,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
