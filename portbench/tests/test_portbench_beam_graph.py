"""beam_graph_pct on hand-made readings: 100 x the program's
``beam_replay`` spans over its ``beam_step`` spans, each replay nested
in its step; None where the program replays no graph (a program older
than the span, or the CPU, where every step runs eagerly)."""

import pytest

from portbench.metrics import beam_graph_pct
from portbench.tests.test_portbench_spans import BEAM, GREEDY, TRAIN
from portbench.trace import Reading


def _read(spans):
    return beam_graph_pct.read(Reading(spans, [], 1.0, {}))


def test_reads_the_share_of_steps_that_replay():
    steps = [s for s in BEAM if s[0] == "beam_step"]
    replays = [("beam_replay", a + 0.001, b - 0.001) for _, a, b in steps]
    assert _read(BEAM + replays) == pytest.approx(100.0)
    assert _read(BEAM + replays[1:]) == pytest.approx(
        100.0 * (len(steps) - 1) / len(steps))


def test_none_without_replays():
    assert _read(BEAM) is None
    assert _read(GREEDY + TRAIN) is None
    assert _read([]) is None
