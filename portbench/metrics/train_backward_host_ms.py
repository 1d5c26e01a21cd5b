"""train_backward_host_ms: the program's ``train_backward`` spans
(zero_grad, backward, the gradients' sum), ms a ``train_step``."""

from ._spans import ms_per


def read(reading):
    return ms_per(reading, ("train_backward",), ("train_step",))
