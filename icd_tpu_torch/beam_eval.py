"""Batched beam-search captioning of the val split (the port of
``tools/beam_eval.py``)::

    python -m icd_tpu_torch.beam_eval <checkpoint> [--beam_size 5]
        [--batch_size 64] [--max_caption_length -1]
        [--out eval_data/<name>_beam.json] [--dtype bf16|f32] [--fused]
        [--int8 | --no-int8] [--act_maxes PATH] [--int8_grid]
        [--device cuda|cpu]

Captions every unique val image at a large batch size and writes a
COCO-results JSON (``[{"image_id": ..., "caption": ...}]``), as the JAX
tool does. ``<checkpoint>`` is a ``.ckpt`` that ``icd_tpu`` wrote,
relative to ``$ICD_TPU_ROOT/checkpoints``. The encoder is the
static-int8 backbone by default (``--int8``), calibrated on the first
val batch; ``--act_maxes PATH`` loads the maxes from a ``.npy`` if it
exists and writes it after calibrating otherwise (the file is the JAX
tool's format). ``--no-int8 --dtype f32`` is the reference-numerics
path. ``--fused`` decodes each batch with K2
(``ops.fused_beam.beam_search_fused``: the whole beam search in one
launch) instead of the per-step loop; ``--int8_grid`` keeps the grid
int8 inside the per-step loop and cannot go with ``--fused``. The whole
checkpoint is cast to ``--dtype`` first, as the JAX tool does.
``--dtype f32`` turns TF32 off. With ``ICD_TPU_PROFILE=<dir>`` the run
is traced into ``<dir>/beam_eval/trace.json`` (``utils.profiling``).
"""

import argparse
import functools
import json
import os

import numpy as np

from .utils.profiling import annotate, maybe_profile


def caption_images(captioner, img_ids, load_batch, vocab, batch_size,
                   log=print):
    """Caption ``img_ids`` in batches (beam_eval.py:138-154).

    ``load_batch(ids)`` returns (N, H, W, 3) uint8 images. The last batch
    is padded to ``batch_size`` by repeating its last image, so every
    batch has one shape; only the real images' captions are kept, the
    words of ``seq[1:seq_len - 1]``. Returns the results list. Under a
    profiler each batch's load is a span ``serve_load``, the fetch of
    its ids ``serve_fetch`` and their words ``serve_detok``.
    """
    results = []
    for i in range(0, len(img_ids), batch_size):
        chunk = img_ids[i: i + batch_size]
        valid = len(chunk)
        with annotate("serve_load"):
            imgs = np.asarray(load_batch(chunk))
            if valid < batch_size:
                imgs = np.concatenate(
                    [imgs, np.repeat(imgs[-1:], batch_size - valid, 0)])
        out = captioner(imgs)
        with annotate("serve_fetch"):
            seqs = out["seq"][:valid].cpu().numpy()
            lens = out["seq_len"][:valid].cpu().numpy()
        with annotate("serve_detok"):
            for img_id, seq, n in zip(chunk, seqs, lens):
                words = [vocab.i2w[int(t)] for t in seq[1: int(n) - 1]]
                results.append({"image_id": int(img_id),
                                "caption": " ".join(words)})
        log("captioned {}/{}".format(min(i + batch_size, len(img_ids)),
                                     len(img_ids)))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--max_caption_length", type=int, default=-1)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--dtype", type=str, default="bf16",
                        choices=["bf16", "f32"], help="compute dtype")
    parser.add_argument("--fused", action="store_true",
                        help="decode with K2, the whole beam search in "
                             "one kernel launch (ops/fused_beam.py)")
    parser.add_argument("--int8", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="static-calibration int8 encoder backbone, "
                             "calibrated on the first val batch (default "
                             "on, as in tools/beam_eval.py)")
    parser.add_argument("--int8_grid", action="store_true",
                        help="per-step loop only: int8 encoder grid and "
                             "attention projection inside the loop")
    parser.add_argument("--act_maxes", type=str, default=None,
                        help="with --int8: .npy of calibrated activation "
                             "maxes; loaded if present, else written "
                             "after calibration")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    if args.fused and args.int8_grid:
        parser.error("--int8_grid applies to the per-step beam loop only; "
                     "it cannot be combined with --fused")
    with maybe_profile("beam_eval"):
        _run(args)


def _run(args):
    """``main``'s work on its parsed arguments."""
    from .checkpoint import load_checkpoint, unpack_checkpoint
    from .data.dataset import COCODataset
    from .decoding.beam import beam_search_batched
    from .decoding.serve import make_beam_captioner
    from .device import dtype_from_name, resolve_device
    from .ops.fused_beam import beam_search_fused
    from .params import decoder_from_jax, encoder_from_jax
    from .pathconf import PathConfig
    from .vocabulary import END_TOKEN, START_TOKEN

    device = resolve_device(args.device)
    dtype = dtype_from_name(args.dtype)
    _, enc_tree, dec_tree, _, _, _ = unpack_checkpoint(load_checkpoint(args))
    encoder = encoder_from_jax(enc_tree).to(dtype)
    dataset = COCODataset("val", caption_max_len=args.max_caption_length)
    vocab = dataset.vocab
    img_ids = dataset.img_ids  # one entry per unique image
    batch_size = max(1, min(args.batch_size, len(img_ids)))
    if args.fused:
        beam_fn = beam_search_fused
    else:
        beam_fn = functools.partial(beam_search_batched,
                                    int8_grid=args.int8_grid)
    int8 = {}
    if args.int8:
        if args.act_maxes and os.path.exists(args.act_maxes):
            int8["act_maxes"] = np.load(args.act_maxes)
            print("Loaded act_maxes from {}".format(args.act_maxes))
        else:
            int8["calib_imgs"] = dataset.load_image_batch(
                img_ids[:batch_size])
    captioner = make_beam_captioner(
        encoder, decoder_from_jax(dec_tree), vocab(START_TOKEN),
        vocab(END_TOKEN), beam_size=args.beam_size, compute_dtype=dtype,
        device=device, beam_fn=beam_fn, **int8)
    if args.act_maxes and "calib_imgs" in int8:
        np.save(args.act_maxes, np.asarray(captioner.act_maxes))
        print("Saved act_maxes to {}".format(args.act_maxes))
    results = caption_images(captioner, img_ids, dataset.load_image_batch,
                             vocab, batch_size)

    out_path = args.out or os.path.join(
        PathConfig.eval_data,
        "{}_beam.json".format(args.checkpoint.split(".")[0]))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f)
    print("Wrote {} captions to {}".format(len(results), out_path))


if __name__ == "__main__":
    main()
