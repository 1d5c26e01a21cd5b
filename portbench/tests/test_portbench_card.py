"""The tiny cells on the card: sound runs of the program come out
correct (through K1 and K2 on the beam cells), the controls do not
(the training cell's is TF32, which exists on the card alone), and the
traced run reads the device. Needs a card; every test skips without
one. On the card: ``python -m pytest -q portbench/tests``."""

import pytest
import torch

from portbench.tests import cells


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.make_root(str(tmp_path_factory.mktemp("root")))


def _run(root, cell, **kw):
    from portbench import harness
    import time

    return harness.run_cell(str(root), cell, 11, 0.5, kw.pop("trace", False),
                            time.time(), device="cuda",
                            log=lambda *a: None, **kw)


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_program_is_correct_on_the_card(card, root, cell):
    result = _run(root, cell, trace=True)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_control_is_not_correct_on_the_card(card, root, cell):
    result = _run(root, cell, variant="control")
    assert result["correct"] is False, result["checks"]
