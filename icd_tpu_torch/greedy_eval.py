"""Greedy captioning of the val split (the port of ``tools/greedy_eval.py``)::

    python -m icd_tpu_torch.greedy_eval <checkpoint>
        [--model_type attention|baseline] [--batch_size 64]
        [--max_len 25] [--max_caption_length -1]
        [--out eval_data/<name>_greedy.json] [--int8] [--act_maxes PATH]
        [--device cuda|cpu]

Captions every unique val image with the greedy serving pipeline of
either model family (``decoding.serve.make_attention_captioner`` or
``make_captioner``; with ``--int8`` ``make_int8_attention_captioner`` or
``make_int8_captioner``: the static-int8 backbone calibrated on the
first val batch, the decoder float) and writes the same COCO-results
JSON as the JAX tool, ``[{"image_id": ..., "caption": ...}]``, each
caption the words before the first ``<end>``. ``--act_maxes PATH``
loads the maxes from a ``.npy`` if it exists, else writes them there
after calibrating. It computes in bf16, as the JAX tool does.
"""

import argparse
import json
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("--model_type", type=str, default="attention",
                        choices=["baseline", "attention"])
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--max_len", type=int, default=25)
    parser.add_argument("--max_caption_length", type=int, default=-1)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--int8", action="store_true",
                        help="serve the encoder with the static-"
                             "calibration int8 backbone (calibrated on "
                             "the first val batch)")
    parser.add_argument("--act_maxes", type=str, default=None,
                        help="with --int8: .npy file of calibrated "
                             "activation maxes; loaded if it exists, "
                             "else written after calibration")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)

    from .checkpoint import load_checkpoint, unpack_checkpoint
    from .data.dataset import COCODataset
    from .decoding.serve import (make_attention_captioner, make_captioner,
                                 make_int8_attention_captioner,
                                 make_int8_captioner)
    from .device import resolve_device
    from .params import decoder_from_jax, encoder_from_jax
    from .pathconf import PathConfig
    from .vocabulary import END_TOKEN, START_TOKEN

    device = resolve_device(args.device)
    _, enc_tree, dec_tree, _, _, _ = unpack_checkpoint(load_checkpoint(args))
    encoder, decoder = encoder_from_jax(enc_tree), decoder_from_jax(dec_tree)
    dataset = COCODataset("val", caption_max_len=args.max_caption_length)
    vocab = dataset.vocab
    start_id, end_id = vocab(START_TOKEN), vocab(END_TOKEN)
    img_ids = dataset.img_ids

    baseline = args.model_type == "baseline"
    if args.int8:
        calib = act_maxes = None
        if args.act_maxes and os.path.exists(args.act_maxes):
            act_maxes = np.load(args.act_maxes)
            print("Loaded act_maxes from {}".format(args.act_maxes))
        else:
            calib = dataset.load_image_batch(img_ids[:args.batch_size])
        make = make_int8_captioner if baseline \
            else make_int8_attention_captioner
        captioner = make(encoder, decoder, start_id, end_id,
                         max_len=args.max_len, calib_imgs=calib,
                         act_maxes=act_maxes, device=device)
        if args.act_maxes and act_maxes is None:
            np.save(args.act_maxes, np.asarray(captioner.act_maxes))
            print("Saved act_maxes to {}".format(args.act_maxes))
    else:
        make = make_captioner if baseline else make_attention_captioner
        captioner = make(encoder, decoder, start_id, end_id,
                         max_len=args.max_len, device=device)

    batch_size = max(1, min(args.batch_size, len(img_ids)))
    results = []
    for i in range(0, len(img_ids), batch_size):
        chunk = img_ids[i: i + batch_size]
        imgs = dataset.load_image_batch(chunk)
        valid = len(chunk)
        if valid < batch_size:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], batch_size - valid, 0)])
        toks = captioner(imgs)
        if not baseline:
            toks = toks[0]  # (tokens, alphas)
        toks = toks[:valid].cpu().numpy()
        for img_id, row in zip(chunk, toks):
            words = []
            for t in row:
                if int(t) == end_id:
                    break
                words.append(vocab.i2w[int(t)])
            results.append({"image_id": int(img_id),
                            "caption": " ".join(words)})
        print("captioned {}/{}".format(min(i + batch_size, len(img_ids)),
                                       len(img_ids)))

    out_path = args.out or os.path.join(
        PathConfig.eval_data,
        "{}_greedy.json".format(args.checkpoint.split(".")[0]))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f)
    print("Wrote {} captions to {}".format(len(results), out_path))


if __name__ == "__main__":
    main()
