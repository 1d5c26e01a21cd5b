"""The comparison that decides ``correct`` fails what it must: the
control (the next precision down in the program's place) and each fault
a cell can have, planted under the timed path, with the rest of a run
driven as the benchmark drives it (on the CPU, at the tiny sizes; the
look for a card skipped). The faults: a token altered where it is
produced, half of the batch left out (the other half's answers in its
place, or the training mean over the rest), and a train step that
leaves its state (the decoder's parameters, or the trunk's BN
statistics) unchanged. One card
is all a cell uses, so no cell can leave out an exchange between chips.
"""

import pytest

from portbench.faults import (SERVING as SERVING_FAULTS, TRAINING as
                              TRAINING_FAULTS)
from portbench.tests import cells


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.make_root(str(tmp_path_factory.mktemp("root")))


SERVING = ("tiny_beam", "tiny_fused_beam", "tiny_greedy")
# The beam cells keep two rows of each request for the check: a window
# of many requests (2 s holds a few even with the tests run in parallel),
# so that rows of both halves of a batch are kept. The
# greedy cell's int8 noise is as wide as a fault's at the tiny sizes:
# one request of the seed its limit was read at.
SECONDS = {"tiny_beam": 2.0, "tiny_fused_beam": 2.0, "tiny_greedy": 0}


@pytest.mark.parametrize("cell", SERVING)
def test_the_control_is_not_correct(root, cell):
    """(The training cell's control, TF32, exists on the card only:
    ``test_portbench_card.py``.)"""
    result = cells.run(root, cell, variant="control", seconds=SECONDS[cell])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", sorted(SERVING_FAULTS))
@pytest.mark.parametrize("cell", SERVING)
def test_a_serving_fault_is_not_correct(root, cell, fault):
    result = cells.run(root, cell, fault=SERVING_FAULTS[fault],
                       seconds=SECONDS[cell])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", sorted(TRAINING_FAULTS))
def test_a_training_fault_is_not_correct(root, fault):
    result = cells.run(root, "tiny_train", fault=TRAINING_FAULTS[fault],
                       seconds=0)
    assert result["correct"] is False, result["checks"]
