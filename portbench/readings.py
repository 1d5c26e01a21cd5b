"""The readings the limits are set from, many seeds in one process::

    python3 -m portbench.readings --workload <cell> --seeds <first> <count> \\
        --seconds <s> [--variant program|control] [--fault <name>]

For each seed, one run of the cell (``harness.run_cell``, at the cell's
own size and load, with a window of ``--seconds``) of the program, its
control, or the program with a fault of ``portbench.faults`` planted;
one JSON line a run with the compared numbers. The benchmark's own
runs never run a control or a fault. Needs a card.
"""

import argparse
import gc
import json
import os
import sys
import time

import torch

from portbench import faults, harness


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs=2, required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--variant", default="program",
                        choices=("program", "control"))
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    traffic = harness.resolve(os.getcwd(), args.workload)[3]
    table = faults.TRAINING if traffic["entry"] == "train" else faults.SERVING
    fault = table[args.fault] if args.fault else None
    first, count = args.seeds
    for seed in range(first, first + count):
        t0 = time.time()
        result = harness.run_cell(os.getcwd(), args.workload, seed,
                                  args.seconds, False, t0,
                                  variant=args.variant, fault=fault,
                                  log=lambda *a: None)
        print(json.dumps({
            "workload": args.workload, "variant": args.variant,
            "fault": args.fault, "seed": seed,
            "checks": {k: v["value"] for k, v in result["checks"].items()},
            "attempted": result["attempted"],
            "seconds": time.time() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
