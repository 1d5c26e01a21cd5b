"""Caption one image by beam search (the port's counterpart of
``gen_captions.py:28-142``, float encoder)::

    python -m icd_tpu_torch.gen_captions <checkpoint> <image>
        [--beam_size 5] [--dtype bf16|f32] [--device cuda|cpu]

``<checkpoint>`` is a ``.ckpt`` that ``icd_tpu`` wrote, named relative to
the checkpoints dir (``$ICD_TPU_ROOT/checkpoints``); the vocabulary is
``$ICD_TPU_ROOT/pkldata/vocab.pkl``. The image is loaded as the
reference's beam loader does: /255 only, no ImageNet mean/std
(gen_captions.py:133-143). ``--dtype f32`` turns TF32 off.
"""

import argparse

import numpy as np


def load_img(path):
    """(1, 224, 224, 3) float32 NHWC in [0, 1] (gen_captions.py:39-47)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((224, 224), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr[None]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Caption generation")
    parser.add_argument("checkpoint", type=str,
                        help="checkpoint of trained attention model.")
    parser.add_argument("image", type=str, help="path to image.")
    parser.add_argument("--beam_size", type=int, default=5,
                        help="beam size.")
    parser.add_argument("--encoder", type=str, default="float",
                        choices=["float", "int8"],
                        help="encoder backbone; only 'float' is ported")
    parser.add_argument("--dtype", type=str, default="bf16",
                        choices=["bf16", "f32"], help="compute dtype")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    if args.encoder == "int8":
        raise NotImplementedError(
            "--encoder int8 is not ported to icd_tpu_torch yet (ROADMAP.md, "
            "Queue 1: the int8 encoder, resnet_int8.py and ops/quant.py); "
            "use --encoder float")

    from .checkpoint import load_checkpoint, unpack_checkpoint
    from .decoding.beam import attention_caption_image_beam_search
    from .device import dtype_from_name, resolve_device, use_exact_f32
    from .params import decoder_from_jax, encoder_from_jax
    from .vocabulary import load_vocab

    device = resolve_device(args.device)
    dtype = dtype_from_name(args.dtype)
    if args.dtype == "f32":
        use_exact_f32()
    _, enc_tree, dec_tree, _, _, _ = unpack_checkpoint(load_checkpoint(args))
    encoder = encoder_from_jax(enc_tree).to(device=device, dtype=dtype)
    decoder = decoder_from_jax(dec_tree).to(device=device, dtype=dtype)
    vocab = load_vocab()
    img = load_img(args.image)
    seq, _, found = attention_caption_image_beam_search(
        args, img, encoder, decoder, vocab)
    print(" ".join(vocab.i2w[t] for t in seq))
    if not found:
        print("(beam search did not complete a caption)")


if __name__ == "__main__":
    main()
