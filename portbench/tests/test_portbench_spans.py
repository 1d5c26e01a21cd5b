"""The readers of the program's own spans: on a hand-made
``trace.Reading`` each returns what its definition says, and None where
the program recorded no such span (a program older than its spans);
traced on the CPU, the tiny cells report them in their cells."""

import importlib
import math

import pytest

from portbench import harness
from portbench.trace import Reading
from portbench.tests import cells

BEAM = [("window", 0.0, 1.0), ("request", 0.0, 0.5),
        ("serve_load", 0.00, 0.01), ("encode", 0.01, 0.10),
        ("serve_upload", 0.01, 0.03), ("decode", 0.10, 0.40),
        ("beam_sync", 0.10, 0.11), ("beam_step", 0.11, 0.13),
        ("beam_sync", 0.13, 0.16), ("beam_step", 0.16, 0.20),
        ("beam_sync", 0.20, 0.21), ("beam_backtrack", 0.21, 0.22),
        ("serve_fetch", 0.40, 0.41), ("serve_detok", 0.41, 0.44)]
GREEDY = [("window", 0.0, 1.0), ("serve_upload", 0.0, 0.004),
          ("greedy_sync", 0.1, 0.101), ("greedy_step", 0.101, 0.103),
          ("greedy_sync", 0.103, 0.106), ("greedy_step", 0.106, 0.110),
          ("serve_upload", 0.5, 0.502)]
TRAIN = [("window", 0.0, 1.0), ("train_wait", 0.0, 0.03)] + [
    (name, t + a, t + b) for t in (0.1, 0.5) for name, a, b in (
        ("step", 0.0, 0.1), ("train_step", 0.0, 0.1),
        ("train_trunk", 0.0, 0.02), ("train_decoder", 0.02, 0.05),
        ("train_backward", 0.05, 0.08), ("train_clip", 0.08, 0.085),
        ("train_adam", 0.085, 0.095), ("train_bn", 0.095, 0.1),
        ("train_wait", 0.1, 0.101))] + [("train_drain", 0.9, 0.95)]

# metric -> (spans, ms it reads there)
WANTED = {"decode_step_host_ms": [(BEAM, 30.0), (GREEDY, 3.0)],
          "decode_sync_ms": [(BEAM, 25.0), (GREEDY, 2.0)],
          "request_host_ms": [(BEAM, 70.0), (GREEDY, 3.0)],
          "train_forward_host_ms": [(TRAIN, 50.0)],
          "train_backward_host_ms": [(TRAIN, 30.0)],
          "train_optim_host_ms": [(TRAIN, 20.0)],
          "train_wait_ms": [(TRAIN, 41.0)]}

BENCHMARK_SPANS = {"window", "request", "encode", "decode", "step"}


def _read(metric, spans):
    reader = importlib.import_module("portbench.metrics." + metric)
    return reader.read(Reading(spans, [], 1.0, {}))


@pytest.mark.parametrize("metric", sorted(WANTED))
def test_reader_on_a_hand_made_reading(metric):
    for spans, ms in WANTED[metric]:
        assert _read(metric, spans) == pytest.approx(ms)
    older = [s for s in BEAM + GREEDY + TRAIN if s[0] in BENCHMARK_SPANS]
    assert _read(metric, older) is None
    assert _read(metric, []) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.make_root(str(tmp_path_factory.mktemp("root")))


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_tiny_cells_traced_report_the_span_metrics(root, cell):
    result = cells.run(root, cell, trace=True)
    assert result["correct"] is True, result["checks"]
    wanted = {m["name"] for m in harness.per_layer(cells.manifest(), cell)
              if m["name"] in WANTED}
    assert wanted
    for name in wanted:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
