"""Eval CLI of the port, with the flags of the root ``eval.py``
(eval.py:26-38) plus ``--device``::

    python -m icd_tpu_torch.eval <checkpoint> --model_type baseline|attention
        [--max_caption_length -1] [--print_freq 1] [--device cuda|cpu]

Loads a checkpoint of the port or of ``icd_tpu`` from
``$ICD_TPU_ROOT/checkpoints``, runs the teacher-forced evaluation of
the val split (``training.baseline.evaluate`` or
``training.attention.evaluate``, f32 with TF32 off; an attention
checkpoint trained ``--use_bert`` is teacher-forced with BERT's
embeddings, BERT read from ``BERT_MODEL_DIR``) and writes the
metric dict, the per-sample losses included, to
``eval_data/<name>.json``. METEOR needs its jar, or
``ICD_TPU_METEOR_PY=1`` (pure Python) or ``ICD_TPU_ALLOW_NO_METEOR=1``
(0.0), as for ``icd_tpu``.
"""

import argparse
import json
import os


def save_eval_data(name, d):
    from .pathconf import PathConfig

    os.makedirs(PathConfig.eval_data, exist_ok=True)
    path = os.path.join(PathConfig.eval_data, "{}.json".format(name))
    with open(path, "w") as f:
        json.dump(d, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation")
    parser.add_argument("checkpoint", type=str,
                        help="checkpoint of trained model.")
    parser.add_argument("--model_type", type=str,
                        choices=["baseline", "attention"],
                        help="type of model to evaluate")
    parser.add_argument("--max_caption_length", type=int, default=-1,
                        help="only use captions with caption length <= 50 "
                             "when training.")
    parser.add_argument("--print_freq", type=int, default=1,
                        help="print training/validation stats every __ "
                             "batches.")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)

    from .checkpoint import load_checkpoint, unpack_checkpoint
    from .device import resolve_device
    from .metric import probe_meteor

    resolve_device(args.device)  # no card and no --device cpu: raise now
    # Probe METEOR before the eval loop: a missing jar fails now.
    probe_meteor()
    chkpt = load_checkpoint(args)
    _, encoder, decoder, _, _, _ = unpack_checkpoint(chkpt)
    if args.model_type == "attention":
        from .training.attention import evaluate

        use_bert = (chkpt.get("config") or {}).get("use_bert", False)
        metrics = evaluate(args, encoder, decoder, use_bert=use_bert,
                           device=args.device)
        print(metrics)
        save_eval_data(args.checkpoint.split(".")[0], metrics)
    elif args.model_type == "baseline":
        from .training.baseline import evaluate

        metrics = evaluate(args, encoder, decoder, device=args.device)
        print(metrics)
        save_eval_data(args.checkpoint.split(".")[0], metrics)


if __name__ == "__main__":
    main()
