"""Train CLI of the port, with the flags of the root ``train.py``
(train.py:29-93) plus ``--device``::

    python -m icd_tpu_torch.train <model_name> --model baseline|attention
        [--attention_dim 512] [--decoder_dim 512] [--decoder_dropout 0.5]
        [--embed_size 512] [--epochs 1] [--batch_size 32] [--workers 1]
        [--encoder_lr 1e-4] [--decoder_lr 1e-4] [--grad_clip 5.]
        [--alpha_c 1.] [--fine_tune_embedding True] [--checkpoint NAME]
        [--print_freq 1] [--use_glove True] [--max_caption_length -1]
        [--fine_tune_encoder True] [--amp True] [--int8_encoder True]
        [--use_bert True] [--device cuda|cpu]

Trains the baseline or the attention captioner
(``training.baseline.train``, ``training.attention.train``), in f32
with TF32 off, or with ``--amp True`` in bf16 over f32 master weights,
Adam moments, loss and BN statistics; ``--int8_encoder True`` runs the
frozen trunk as the static-int8 ResNet-101 (16 batches of train-mode
BN warm-up, then calibration; BN statistics do not update while
training). Each epoch writes ``checkpoints/<model_name>_<epoch>.ckpt``,
which ``icd_tpu`` loads. ``--checkpoint`` resumes from a checkpoint of
the port or of ``icd_tpu``. ``--fine_tune_encoder`` trains the
baseline's ``embed`` head. Bool flags parse as the reference's
(``type=bool``: any non-empty string is True), ``--amp`` and
``--int8_encoder`` strictly. ``--use_glove`` needs ``--embed_size 300``;
``--use_bert`` needs ``--model attention`` and ``--embed_size 768``, and
reads BERT from the ``save_pretrained`` directory ``BERT_MODEL_DIR``:
its embeddings of each caption replace the decoder's table, which stays
frozen (made on the run's device; ``ICD_TPU_BERT_INT8=1``: W8A8).
"""

import argparse
import os


def _strict_bool(value):
    """Real boolean parsing for the extension flags (train.py:17)."""
    lowered = value.strip().lower()
    if lowered in ("true", "1", "yes", "on"):
        return True
    if lowered in ("false", "0", "no", "off", ""):
        return False
    raise argparse.ArgumentTypeError(
        "expected a boolean, got {!r}".format(value))


def build_parser():
    parser = argparse.ArgumentParser(description="Train")
    parser.add_argument("model_name", type=str,
                        help="unique name of model setting; saved with this "
                             "name in checkpoints folder.")
    parser.add_argument("--model", type=str,
                        choices=["baseline", "attention"],
                        help="Model to train")
    parser.add_argument("--attention_dim", type=int, default=512,
                        help="attention dimension.")
    parser.add_argument("--decoder_dim", type=int, default=512,
                        help="decoder dimension.")
    parser.add_argument("--decoder_dropout", type=float, default=0.5,
                        help="decoder dropout probability.")
    parser.add_argument("--embed_size", type=int, default=512,
                        help="embedding dimension. If using pre-trained "
                             "glove vectors, use 300.")
    parser.add_argument("--epochs", type=int, default=1,
                        help="number of epochs to train for.")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="batch_size.")
    parser.add_argument("--workers", type=int, default=1,
                        help="for data-loading.")
    parser.add_argument("--encoder_lr", type=float, default=1e-4,
                        help="learning rate for encoder if fine-tuning.")
    parser.add_argument("--decoder_lr", type=float, default=1e-4,
                        help="learning rate for decoder.")
    parser.add_argument("--grad_clip", type=float, default=5.,
                        help="clip gradients at an absolute value of.")
    parser.add_argument("--alpha_c", type=float, default=1.,
                        help="regularization parameter for doubly stochastic "
                             "attention, as in the paper.")
    parser.add_argument("--fine_tune_encoder", type=bool, default=False,
                        help="whether to fine-tune encoder or not.")
    parser.add_argument("--fine_tune_embedding", type=bool, default=False,
                        help="whether to fine-tune word embeddings or not.")
    parser.add_argument("--checkpoint", default=None, type=str,
                        help="name of checkpoint in ./checkpoints folder; "
                             "None if none.")
    parser.add_argument("--print_freq", type=int, default=1,
                        help="print training/validation stats every __ "
                             "batches.")
    parser.add_argument("--use_glove", type=bool, default=False,
                        help="whether to use pre-trained glove embeddings.")
    parser.add_argument("--max_caption_length", type=int, default=-1,
                        help="only use captions with caption length <= 50 "
                             "when training.")
    parser.add_argument("--use_bert", type=bool, default=False,
                        help="whether to use BERT embeddigns for attention "
                             "model.")
    parser.add_argument("--amp", type=_strict_bool, default=False,
                        help="bf16 mixed-precision training (f32 master "
                             "weights, loss, optimizer and BN statistics)")
    parser.add_argument("--int8_encoder", type=_strict_bool, default=False,
                        help="run the frozen encoder backbone as the "
                             "static-calibration int8 trunk during training "
                             "(BN running statistics do not update)")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .device import resolve_device
    from .pathconf import PathConfig

    resolve_device(args.device)  # no card and no --device cpu: raise now
    if not os.path.exists(PathConfig.vocab_file):
        raise SystemError(
            'Must run "python -m icd_tpu_torch.init --vocab True" before '
            'training.')
    if args.use_glove:
        if not os.path.exists(PathConfig.glove_vectors):
            raise SystemError(
                'Must run "python -m icd_tpu_torch.init --glove True" when '
                'using glove vectors.')
        if args.embed_size != 300:
            raise ValueError(
                "Expected embedding size of 300 for glove vectors.")
    if args.use_bert:
        if args.model != "attention":
            raise ValueError("BERT is only used for attention model.")
        if args.embed_size != 768:
            raise ValueError("Expected embedding size of 768 for BERT.")
    if args.model == "baseline":
        print("Training baseline model...")
        from .training.baseline import train

        train(args, device=args.device)
    elif args.model == "attention":
        print("Training attention model...")
        from .training.attention import train

        train(args, device=args.device)


if __name__ == "__main__":
    main()
