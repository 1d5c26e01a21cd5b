"""Tiny cells for the CPU tests: a checkout root in a temporary
directory holding a ``BENCHMARK.json`` of four cells at test-only
sizes (``data/``), one for each entry, and ``run(...)``, which drives a
whole run through ``portbench.harness`` on the CPU (the look for a card
skipped)."""

import json
import os
import shutil
import time

from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

CELLS = {"tiny_beam": ("tiny-sat", "tiny_beam"),
         "tiny_fused_beam": ("tiny-sat", "tiny_fused_beam"),
         "tiny_greedy": ("tiny-baseline", "tiny_greedy"),
         "tiny_train": ("tiny-sat", "tiny_train")}

# Limits at the tiny sizes, in float32 (the greedy cell's program in
# int8), set from the CPU's readings at the tests' seed 7 with a window
# of one request: sound runs read ranks within the beam and alpha gaps
# under 1e-6 (beam), 0.0019 (greedy, int8) and under 1e-5 (train); the
# controls and faults 0.03 and more, or ranks past the beam (the BN gap
# alone fails the stale statistics, at 1).
LIMITS = {"tiny_beam": {"topk_rank": {"limit": 5},
                        "alpha_gap": {"limit": 1e-4},
                        "unfinished": {"limit": 0}},
          "tiny_fused_beam": {"topk_rank": {"limit": 5},
                              "alpha_gap": {"limit": 1e-4},
                                    "unfinished": {"limit": 0}},
          "tiny_greedy": {"greedy_gap": {"limit": 0.02}},
          "tiny_train": {"loss_gap": {"limit": 1e-5},
                         "grad_gap": {"limit": 1e-3},
                         "change_gap": {"limit": 1e-2},
                         "bn_gap": {"limit": 1e-4}}}


def manifest():
    with open(os.path.join(HERE, "..", "..", "BENCHMARK.json")) as f:
        real = json.load(f)
    serve = ["tiny_beam", "tiny_fused_beam", "tiny_greedy"]

    def retarget(metrics):
        out = []
        for m in metrics:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [
                    {"sat_beam_b64": "tiny_beam",
                     "sat_fused_beam_b64": "tiny_fused_beam",
                     "base_greedy_int8_b64": "tiny_greedy",
                     "sat_train_b32": "tiny_train"}[w] for w in m["workloads"]]
            out.append(m)
        return out

    return dict(
        real,
        configs=[{"name": c, "source": "test",
                  "file": "portbench/configs/{}.json".format(c),
                  "reduced": [], "why": "test"}
                 for c in ("tiny-sat", "tiny-baseline")],
        workloads=[{"name": n, "config": c, "traffic": t, "chips": 1,
                    "why": "test"} for n, (c, t) in CELLS.items()],
        end_to_end=retarget(real["end_to_end"]),
        per_layer=retarget(real["per_layer"]),
        serve=serve)


def make_root(path):
    """A checkout root under ``path`` with the tiny cells' files."""
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(path, "portbench", sub), exist_ok=True)
    for c in ("tiny-sat", "tiny-baseline"):
        shutil.copy(os.path.join(DATA, c + ".json"),
                    os.path.join(path, "portbench", "configs"))
    for _, t in CELLS.values():
        shutil.copy(os.path.join(DATA, t + ".json"),
                    os.path.join(path, "portbench", "traffic"))
    for cell, lim in LIMITS.items():
        with open(os.path.join(path, "portbench", "limits",
                               cell + ".json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(manifest(), f)
    return path


def run(root, cell, seed=7, seconds=0.5, trace=False, variant="program",
        fault=None):
    return harness.run_cell(str(root), cell, seed, seconds, trace,
                            time.time(), device="cpu", variant=variant,
                            fault=fault, log=lambda *a: None)
