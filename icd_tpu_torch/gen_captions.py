"""Caption one image by beam search (the port's counterpart of
``gen_captions.py:28-142``)::

    python -m icd_tpu_torch.gen_captions <checkpoint> <image>
        [--beam_size 5] [--encoder int8|float] [--dtype bf16|f32]
        [--device cuda|cpu]

``<checkpoint>`` is a ``.ckpt`` that ``icd_tpu`` wrote, named relative to
the checkpoints dir (``$ICD_TPU_ROOT/checkpoints``); the vocabulary is
``$ICD_TPU_ROOT/pkldata/vocab.pkl``. The image is loaded as the
reference's beam loader does: /255 only, no ImageNet mean/std
(gen_captions.py:133-143). The default encoder is the static-int8
backbone calibrated on the input image itself, as the JAX CLI's
(``_beam_search_int8``, gen_captions.py:50-90); ``--encoder float
--dtype f32`` is the reference-numerics path. ``--dtype f32`` turns
TF32 off.
"""

import argparse

import numpy as np


def load_img(path):
    """(1, 224, 224, 3) float32 NHWC in [0, 1] (gen_captions.py:39-47):
    PIL's pixels, from the port's codec for a JPEG (no PIL needed)."""
    from .data.dataset import decode_image

    arr = np.asarray(decode_image(path, 224), np.float32) / 255.0
    return arr[None]


def _beam_search_int8(args, img, encoder, decoder, vocab, dtype, device):
    """int8 encoder + ``dtype`` beam over one image (gen_captions.py:50):
    (seq, Caption_End). The whole encoder and decoder are cast to
    ``dtype`` first, BN statistics included, so that in bf16 the folded
    BN uses the rounded statistics; the activation maxes are calibrated
    on the image itself."""
    import torch

    from .decoding.beam import beam_search_batched
    from .models.encoder import encoder_attention_forward_int8
    from .models.resnet_int8 import calibrate_act_maxes, quantize_resnet
    from .vocabulary import END_TOKEN, START_TOKEN

    encoder = encoder.to(device=device, dtype=dtype)
    decoder = decoder.to(device=device, dtype=dtype)
    with torch.inference_mode():
        x = torch.as_tensor(img).to(device=device, dtype=dtype)
        act_maxes = calibrate_act_maxes(encoder.resnet, x, dtype)
        qresnet = quantize_resnet(encoder.resnet, act_maxes)
        grid = encoder_attention_forward_int8(qresnet, x, dtype)
        out = beam_search_batched(decoder, grid, args.beam_size,
                                  vocab(START_TOKEN), vocab(END_TOKEN))
    if not bool(out["found"][0]):
        return [vocab(START_TOKEN), vocab(END_TOKEN)], False
    return out["seq"][0, :int(out["seq_len"][0])].tolist(), True


def main(argv=None):
    parser = argparse.ArgumentParser(description="Caption generation")
    parser.add_argument("checkpoint", type=str,
                        help="checkpoint of trained attention model.")
    parser.add_argument("image", type=str, help="path to image.")
    parser.add_argument("--beam_size", type=int, default=5,
                        help="beam size.")
    parser.add_argument("--encoder", type=str, default="int8",
                        choices=["int8", "float"],
                        help="encoder backbone: static-int8 (default) or "
                             "float")
    parser.add_argument("--dtype", type=str, default="bf16",
                        choices=["bf16", "f32"], help="compute dtype")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)

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
    encoder = encoder_from_jax(enc_tree)
    decoder = decoder_from_jax(dec_tree)
    vocab = load_vocab()
    img = load_img(args.image)
    if args.encoder == "int8":
        seq, found = _beam_search_int8(args, img, encoder, decoder, vocab,
                                       dtype, device)
    else:
        seq, _, found = attention_caption_image_beam_search(
            args, img, encoder.to(device=device, dtype=dtype),
            decoder.to(device=device, dtype=dtype), vocab)
    print(" ".join(vocab.i2w[t] for t in seq))
    if not found:
        print("(beam search did not complete a caption)")


if __name__ == "__main__":
    main()
