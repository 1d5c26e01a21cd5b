"""One run of one cell: the manifest, the cell's files, the order of a
run, and its result line.

A run (``run_cell``) reads ``BENCHMARK.json`` at the checkout's root,
finds the cell's configuration (``portbench/configs/<config>.json``),
traffic mix (``portbench/traffic/<traffic>.json``, whose ``entry``
names the driver ``portbench/entries/<entry>.py``) and limits
(``portbench/limits/<cell>.json``), and then:

1. the entry's ``build``: inputs and weights from the seed, the
   program's captioner or train step, warm-up (the set-up, ``setup_s``
   counts from the process's start to here);
2. the entry's ``window``: the timed loop, ``seconds`` long;
3. with ``trace``, the entry's ``traced``: a block of the same calls
   under ``torch.profiler``, read by the per-layer metrics'
   ``portbench/metrics/<metric>.py``;
4. the device's peak memory, then the entry's ``check``: the program's
   state freed, the plain reference run over a sample of what the
   window produced, each number against its limit.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import trace as tracing

# Top-level modules that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "icd_tpu")


def load_json(root, path):
    with open(os.path.join(root, path)) as f:
        return json.load(f)


class Cell:
    """What an entry is given: the cell's name, configuration, traffic
    and limits, the seed, the device, the variant (``program``, or
    ``control``, which the limits' readings run in its place) and a
    ``fault`` that the tests plant under the timed path (None in every
    run of the benchmark)."""

    def __init__(self, name, config, traffic, limits, seed, device,
                 variant="program", fault=None, started=None):
        self.name, self.config, self.traffic = name, config, traffic
        self.limits, self.seed, self.device = limits, seed, device
        self.variant, self.fault = variant, fault
        self.marks = [("start", time.time() if started is None else started)]

    def mark(self, phase):
        """Note the end of a phase of the set-up."""
        self.marks.append((phase, time.time()))

    def phases(self):
        return ", ".join("{} {:.3f}".format(name, t - self.marks[i][1])
                         for i, (name, t) in enumerate(self.marks[1:]))


def resolve(root, workload):
    """(manifest, workload entry, Cell fields) of ``workload``."""
    manifest = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit("unknown workload {!r}; BENCHMARK.json has {}"
                         .format(workload, sorted(cells)))
    wl = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root, configs[wl["config"]]["file"])
    traffic = load_json(root, os.path.join(
        "portbench", "traffic", wl["traffic"] + ".json"))
    limits = load_json(root, os.path.join(
        "portbench", "limits", workload + ".json"))
    return manifest, wl, config, traffic, limits


def _reported(metric, workload):
    cells = metric.get("workloads")
    return cells is None or workload in cells


def end_to_end(manifest, workload):
    return [m for m in manifest["end_to_end"] if _reported(m, workload)]


def per_layer(manifest, workload):
    moved = {m["name"] for m in end_to_end(manifest, workload)}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(device, count):
    """The ``device`` object of the result line."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(root, workload, seed, seconds, trace, started, device="cuda",
             variant="program", fault=None, log=None):
    """One run; returns the result line's object (``checks`` last)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    manifest, wl, config, traffic, limits = resolve(root, workload)
    cell = Cell(workload, config, traffic, limits, seed,
                torch.device(device), variant, fault, started)
    entry = importlib.import_module("portbench.entries." + traffic["entry"])

    cell.mark("imports")
    state = entry.build(cell)
    sync(device)
    cell.mark("warm-up")
    setup_s = time.time() - started
    log("portbench: set-up {:.3f} s ({})".format(setup_s, cell.phases()))
    window = entry.window(state, seconds)
    log("portbench: window {:.3f} s, {} attempted".format(
        window["seconds"], window["attempted"]))
    result = {"correct": False, "attempted": window["attempted"],
              "failed": window["failed"]}

    reading = None
    if trace:
        reading = entry.traced(state, tracing.Tracer(cell.device))
        reading.counters.update(window["counters"])
    dev = device_info(device, wl["chips"])

    checks = entry.check(state)
    result["correct"] = bool(checks) and all(
        _finite(v) and v <= limit for _, v, limit in checks)

    metrics = {}
    if not trace:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in end_to_end(manifest, workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        reading.config, reading.traffic = config, traffic
        for m in per_layer(manifest, workload):
            reader = importlib.import_module("portbench.metrics." + m["name"])
            value = reader.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = reading.busy_s, reading.window_s
    result["metrics"] = metrics
    result["device"] = dev
    if trace:
        result["breakdown"] = reading.breakdown()
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    for name, v, limit in checks:
        log("check {} {!r} limit {!r}".format(name, v, limit))
    return result
