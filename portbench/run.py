"""The benchmark of ``icd_tpu_torch`` on one NVIDIA H100::

    python3 -m portbench.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

run from the root of a checkout. One run of one cell of
``BENCHMARK.json`` (``portbench/harness.py``); the last line of
standard output is the result, one JSON object, and the last lines of
standard error are each checked number beside its limit. Without a
CUDA card, or with fewer cards than the cell asks for, it exits 2 and
prints no result; so it does if JAX or the JAX package was loaded. The
program's kernels build into ``build/`` inside the checkout at their
first use; every cache a run writes stays inside the checkout, ``HOME``,
``XDG_CACHE_HOME`` or ``TMPDIR``.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
# Every cache a run fills lives at a fixed path in the checkout's build/,
# so that only a cell's first run there fills it: the program's kernels
# (build/, the program's own choice), and the bytecode of every module
# imported from here on, torch's too (compiled anew in every process
# where no bytecode may be written: 8 s of each run's set-up).
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``icd_tpu_torch`` is not ``icd_tpu``)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(harness.FORBIDDEN))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _, wl, _, _, _ = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print("portbench: {} needs {} cards, {} found".format(
            args.workload, wl["chips"], torch.cuda.device_count()),
            file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), STARTED)
    bad = forbidden_modules()
    if bad:
        print("portbench: loaded {}".format(", ".join(bad)), file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
