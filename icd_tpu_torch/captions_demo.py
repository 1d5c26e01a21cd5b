"""Side-by-side teacher-forced captions of trained checkpoints (port of
``tools/captions_demo.py``, the reference's captions.ipynb cells 0-5)::

    python -m icd_tpu_torch.captions_demo ckpt1[:baseline] ckpt2[:attention]
        ... [--num_images 3] [--seed 67] [--device cuda|cpu]

Loads each checkpoint from ``$ICD_TPU_ROOT/checkpoints`` with the port's
loader (a ``.ckpt`` of either package, or a reference ``.pth.tar``), and
for ``--num_images`` val images drawn with a seeded numpy generator
prints the image path, the ground truth and each model's argmax caption
under teacher forcing (``caption_teacher_forced``), f32 with TF32 off.
An entry without ``:type`` is an attention model when its name holds
"att", else a baseline one. A checkpoint trained ``--use_bert`` is
teacher-forced with BERT's caption embeddings (``BERT_MODEL_DIR``) made
on the same device, as the reference's pickled decoder does
(attention.py:242-247). Runs on the card unless ``--device cpu``.
"""

import argparse

import numpy as np
import torch


def image_features(model_type, encoder, img):
    """One (H, W, 3) uint8 image's encoder output on the encoder's
    device: (1, embed) features for the baseline model, the (1, 14, 14,
    2048) grid for the attention model."""
    from .models.encoder import encoder_attention_forward, encoder_forward

    device = next(encoder.parameters()).device
    imgs = torch.tensor(np.asarray(img)[None], device=device)
    with torch.no_grad():
        if model_type == "baseline":
            return encoder_forward(encoder, imgs)
        return encoder_attention_forward(encoder, imgs)


def decoder_scores(model_type, decoder, features, caption,
                   bert_embedder=None):
    """The decoder's scores under teacher forcing of the (T,) token ids
    ``caption`` on ``image_features``' output: (1, T, V) for the baseline
    model, (1, T - 1, V) for the attention model, f32 on the decoder's
    device."""
    from .models.attention import attention_decoder_forward
    from .models.baseline import baseline_decoder_forward

    device = next(decoder.parameters()).device
    features = features.to(device)
    caps = torch.tensor(np.asarray(caption, np.int64)[None], device=device)
    with torch.no_grad():
        if model_type == "baseline":
            return baseline_decoder_forward(decoder, features, caps).float()
        embeddings = (bert_embedder(caps.cpu().numpy())
                      if bert_embedder is not None else None)
        lengths = torch.tensor([caps.shape[1] - 1], device=device)
        scores, _ = attention_decoder_forward(decoder, features, caps,
                                              lengths, embeddings=embeddings)
    return scores.float()


def caption_teacher_forced(model_type, encoder, decoder, img, caption,
                           vocab, bert_embedder=None):
    """Argmax caption of one (H, W, 3) uint8 image ``img`` under teacher
    forcing of its (T,) token ids ``caption``, like captions.ipynb: the
    words of the scores' argmax without the special tokens, joined by
    spaces."""
    from .vocabulary import END_TOKEN, PAD_TOKEN, START_TOKEN

    special = {vocab(START_TOKEN), vocab(END_TOKEN), vocab(PAD_TOKEN)}
    scores = decoder_scores(model_type, decoder,
                            image_features(model_type, encoder, img),
                            caption, bert_embedder)
    preds = scores.argmax(-1)[0].tolist()
    return " ".join(vocab.i2w[t] for t in preds if t not in special)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoints", nargs="+",
                        help="name.ckpt[:model_type] entries")
    parser.add_argument("--num_images", type=int, default=3)
    parser.add_argument("--seed", type=int, default=67)
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)

    from .checkpoint import load_checkpoint, unpack_checkpoint
    from .data.dataset import COCODataset
    from .device import resolve_device, use_exact_f32
    from .params import decoder_from_jax, encoder_from_jax

    device = resolve_device(args.device)
    use_exact_f32()
    dataset = COCODataset("val", caption_max_len=-1)
    models = []
    bert_embedder = None
    for entry in args.checkpoints:
        name, _, mtype = entry.partition(":")
        mtype = mtype or ("attention" if "att" in name else "baseline")
        chkpt = load_checkpoint(name=name, verbose=False)
        _, enc, dec, _, _, _ = unpack_checkpoint(chkpt)
        embedder = None
        if (chkpt.get("config") or {}).get("use_bert", False):
            if bert_embedder is None:
                from .models.bert_embed import BertCaptionEmbedder

                bert_embedder = BertCaptionEmbedder(dataset.vocab,
                                                    device=device)
            embedder = bert_embedder
        models.append((name, mtype, encoder_from_jax(enc).to(device),
                       decoder_from_jax(dec).to(device), embedder))
    rng = np.random.default_rng(args.seed)
    for idx in rng.choice(len(dataset), args.num_images, replace=False):
        img, caption, img_path, _ = dataset[int(idx)]
        truth = " ".join(dataset.vocab.i2w[int(t)] for t in caption[1:-1])
        print("=" * 60)
        print("image:", img_path)
        print("truth:", truth)
        for name, mtype, enc, dec, embedder in models:
            cap = caption_teacher_forced(mtype, enc, dec, img, caption,
                                         dataset.vocab,
                                         bert_embedder=embedder)
            print("{:>24}: {}".format(name, cap))


if __name__ == "__main__":
    main()
