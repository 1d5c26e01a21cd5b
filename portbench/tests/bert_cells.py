"""The tiny BERT cell for the CPU tests, beside ``cells``' four:
``tiny_train_bert`` (``data/tiny-sat-bert.json`` under
``data/tiny_train_bert.json``: 2 layers, hidden 64, 4 heads, FFN 128,
200 WordPiece entries, E = 64) stands for ``sat_train_bert_b32``.

``manifest(names)`` is the repository's ``BENCHMARK.json`` retargeted
at the tiny cells ``names``, as ``cells.manifest`` retargets it at its
four: each real cell's name in a metric's ``workloads`` becomes its
tiny cell's, and a cell with no tiny counterpart among ``names`` is
left out. ``conftest.py`` gives ``cells`` the four-cell form of it, so
that a cell the repository adds does not break ``cells.manifest``."""

import json
import os
import shutil

from portbench.tests import cells

CELL = "tiny_train_bert"
CONFIG, TRAFFIC = "tiny-sat-bert", "tiny_train_bert"
TINY = {"sat_beam_b64": "tiny_beam", "sat_fused_beam_b64": "tiny_fused_beam",
        "base_greedy_int8_b64": "tiny_greedy", "sat_train_b32": "tiny_train",
        "sat_train_bert_b32": CELL}
ALL = dict(cells.CELLS, **{CELL: (CONFIG, TRAFFIC)})

# Limits at the tiny size, in float32 on the CPU, set from the readings
# at seeds 7 and 2**33 + 5 with a window of one step: the program reads
# 0 mismatched rows, embed_gap under 4e-7, loss_gap under 1e-7, grad_gap
# under 2e-6, change_gap under 2e-4 and bn_gap under 2e-6; the unpadded
# control reads 8 or more mismatched rows, embed_gap over 0.5 and the
# train gaps 1e-2 and more.
LIMITS = {"piece_mismatch": {"limit": 0},
          "embed_gap": {"limit": 1e-5},
          "loss_gap": {"limit": 1e-5},
          "grad_gap": {"limit": 1e-3},
          "change_gap": {"limit": 1e-2},
          "bn_gap": {"limit": 1e-4}}


def manifest(names=tuple(ALL)):
    with open(os.path.join(cells.HERE, "..", "..", "BENCHMARK.json")) as f:
        real = json.load(f)

    def retarget(metrics):
        out = []
        for m in metrics:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [TINY[w] for w in m["workloads"]
                                  if TINY.get(w) in names]
            out.append(m)
        return out

    configs = sorted({ALL[n][0] for n in names})
    return dict(
        real,
        configs=[{"name": c, "source": "test",
                  "file": "portbench/configs/{}.json".format(c),
                  "reduced": [], "why": "test"} for c in configs],
        workloads=[{"name": n, "config": ALL[n][0], "traffic": ALL[n][1],
                    "chips": 1, "why": "test"} for n in names],
        end_to_end=retarget(real["end_to_end"]),
        per_layer=retarget(real["per_layer"]),
        serve=[n for n in ("tiny_beam", "tiny_fused_beam", "tiny_greedy")
               if n in names])


def four_cells():
    """``cells.manifest``'s four cells, the real cells they do not stand
    for left out of the metrics' lists."""
    return manifest(tuple(cells.CELLS))


def make_root(path):
    """A checkout root under ``path`` with the five tiny cells' files."""
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(path, "portbench", sub), exist_ok=True)
    for config, traffic in ALL.values():
        shutil.copy(os.path.join(cells.DATA, config + ".json"),
                    os.path.join(path, "portbench", "configs"))
        shutil.copy(os.path.join(cells.DATA, traffic + ".json"),
                    os.path.join(path, "portbench", "traffic"))
    for cell, lim in dict(cells.LIMITS, **{CELL: LIMITS}).items():
        with open(os.path.join(path, "portbench", "limits",
                               cell + ".json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(manifest(), f)
    return path
