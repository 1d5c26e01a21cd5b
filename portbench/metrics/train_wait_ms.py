"""train_wait_ms: the program's ``train_wait`` (each fetch of the next
staged batch) and ``train_drain`` (each fetch of a block of losses)
spans, ms a ``train_step``: the host waiting, not dispatching work."""

from ._spans import ms_per


def read(reading):
    return ms_per(reading, ("train_wait", "train_drain"), ("train_step",))
