"""Training-loss plot from checkpoints (port of
``tools/training_plots.py``, the reference's training_plots.ipynb
cells 2-8)::

    python -m icd_tpu_torch.training_plots [ckpt ...]

Reads the ``epoch_losses`` history of each listed checkpoint (by its
file name, from ``$ICD_TPU_ROOT/checkpoints``; every ``*.ckpt`` there
by default) with the port's loader, keeps the last one listed per model
prefix, and plots each model's running-average loss into
``train_loss.jpg`` in the working directory. Host only; matplotlib is
imported by ``main``.
"""

import argparse
import glob
import os


def avg_losses(epoch_losses):
    """Flatten epochs and compute the running average (reference:
    training_plots.ipynb avg_losses)."""
    flat = [loss for epoch in epoch_losses for loss in epoch]
    avgs, total = [], 0.0
    for i, loss in enumerate(flat):
        total += loss
        avgs.append(total / (i + 1))
    return avgs


def create_losses_plot(histories, out_path="train_loss.jpg"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for name, losses in histories.items():
        ax.plot(avg_losses(losses), label=name)
    ax.set_xlabel("batch")
    ax.set_ylabel("running avg loss")
    ax.legend()
    ax.set_title("Training loss")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("Saved {}".format(out_path))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoints", nargs="*",
                        help="checkpoint files (default: every *.ckpt in "
                             "the checkpoints dir)")
    args = parser.parse_args(argv)

    from .checkpoint import load_checkpoint
    from .pathconf import PathConfig

    paths = args.checkpoints or sorted(glob.glob(
        os.path.join(PathConfig.checkpoints_dir, "*.ckpt")))
    histories = {}
    for path in paths:
        name = os.path.basename(path)
        chkpt = load_checkpoint(name=name, verbose=False)
        losses = chkpt.get("metrics", {}).get("epoch_losses")
        if losses:
            # keep the latest checkpoint per model prefix
            histories[name.rsplit("_", 1)[0]] = losses
    if not histories:
        print("No checkpoints with epoch_losses found.")
        return
    create_losses_plot(histories)


if __name__ == "__main__":
    main()
