"""Validation-metric tables from eval_data JSONs (port of
``tools/validation_plots.py``, the reference's validation_plots.ipynb
cells 1-5)::

    python -m icd_tpu_torch.validation_plots

Reads every ``$ICD_TPU_ROOT/eval_data/*.json`` (what ``python -m
icd_tpu_torch.eval`` writes) and prints BLEU-1..4, METEOR, ROUGE-L,
CIDEr and the mean loss per model as a GitHub table and a LaTeX one.
Host only; tabulate is imported by ``main``.
"""

import argparse
import glob
import json
import os

import numpy as np

METRIC_KEYS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
               "METEOR", "ROUGE_L", "CIDEr"]


def get_metrices(path):
    """Metric row for one eval json (reference: validation_plots.ipynb
    get_metrices)."""
    with open(path) as f:
        data = json.load(f)
    row = [round(data.get(key, float("nan")), 4) for key in METRIC_KEYS]
    losses = data.get("losses", [])
    row.append(round(float(np.mean(losses)), 4) if losses else float("nan"))
    return row


def main(argv=None):
    from tabulate import tabulate

    from .pathconf import PathConfig

    argparse.ArgumentParser().parse_args(argv)
    paths = sorted(glob.glob(os.path.join(PathConfig.eval_data, "*.json")))
    if not paths:
        print("No eval_data/*.json found.")
        return
    headers = ["model"] + METRIC_KEYS + ["mean loss"]
    rows = [[os.path.splitext(os.path.basename(p))[0]] + get_metrices(p)
            for p in paths]
    print(tabulate(rows, headers=headers, tablefmt="github"))
    print()
    print(tabulate(rows, headers=headers, tablefmt="latex"))


if __name__ == "__main__":
    main()
