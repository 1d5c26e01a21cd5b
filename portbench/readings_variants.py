"""The readings of an entry's own variants, many seeds in one process::

    python3 -m portbench.readings_variants --workload <cell> \\
        [--variant <name>] [--fault <name>] --seeds <first> <count> \\
        --seconds <s>

As ``portbench.readings``, for what ``portbench.readings`` does not
offer: a variant the cell's entry names beside ``program`` and
``control`` (``train_bert``'s ``bert_tf32`` and ``unpadded``), or a
fault of the entry's own ``FAULTS`` (``train_bert``'s). One JSON line a
run with the compared numbers. Needs a card.
"""

import argparse
import gc
import importlib
import json
import os
import sys
import time

import torch

from portbench import harness


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--variant", default="program")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seeds", type=int, nargs=2, required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings_variants: no CUDA device", file=sys.stderr)
        return 2
    fault = None
    if args.fault:
        entry = harness.resolve(os.getcwd(), args.workload)[3]["entry"]
        fault = importlib.import_module(
            "portbench.entries." + entry).FAULTS[args.fault]
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
