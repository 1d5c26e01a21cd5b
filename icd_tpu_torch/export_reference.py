"""Export a checkpoint to the reference's ``.pth.tar`` format (port of
``tools/export_reference.py``)::

    ICD_TPU_ROOT=... python -m icd_tpu_torch.export_reference \\
        <name>_<epoch>.ckpt out.pth.tar --reference_root DIR \\
        [--decoder_lr 4e-4]

Reads the checkpoint (the port's or icd_tpu's ``.ckpt``, or a reference
``.pth.tar``) from ``$ICD_TPU_ROOT/checkpoints`` and writes a
whole-module PyTorch checkpoint that the unmodified reference code
consumes (``export.export_reference_checkpoint``: the reference's own
classes from ``--reference_root``, a fresh decoder Adam). Runs on the
host; no card is needed.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export to .pth.tar")
    parser.add_argument("checkpoint", help="checkpoint file name (under "
                                           "checkpoints/)")
    parser.add_argument("out_path", help="destination .pth.tar")
    parser.add_argument("--reference_root", required=True,
                        help="checkout of the reference (its classes)")
    parser.add_argument("--decoder_lr", type=float, default=4e-4,
                        help="rate of the exported fresh decoder Adam")
    args = parser.parse_args(argv)

    from .checkpoint import load_checkpoint
    from .export import export_reference_checkpoint

    chkpt = load_checkpoint(name=args.checkpoint, verbose=True)
    out = export_reference_checkpoint(
        chkpt, args.out_path, reference_root=args.reference_root,
        decoder_lr=args.decoder_lr)
    print("Exported reference checkpoint to {}".format(out))


if __name__ == "__main__":
    main()
